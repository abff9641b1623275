#!/usr/bin/env python3
"""Drive the PyTorch port's flat ANN, quantized, closest-pair, streaming,
PM-tree and sharded paths, its serving front end, its LM serving path
(every model family) and its LM training path on one NVIDIA GPU, and
check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

  build    nvcc builds every kernel of ``src/repro_torch/kernels/csrc``.
  data     a synthetic clustered twin of Deep1M's published shape (paper
           Table 3: n = 1,000,000, d = 256, float32), made with numpy from
           ``--seed``, indexed by ``repro_torch.index.build_index`` on the
           card.
  parity   each CUDA kernel against its plain PyTorch version, on the
           same tensors, at the shapes the main path gives it and at edge
           shapes (padding, k > Tc, ties, seeds outside the ladder, an
           overflowing tie cluster; radius_select on collapsed brackets,
           values near FLT_MAX, +inf and NaN entries and small integers;
           verify with a row in every query's list and twice in one, a
           NaN row, B = 130 (two groups of queries) and d = 600; topk at
           k = 1 and 128, short and ragged rows, equal values, rows with
           fewer than k finite entries, ascending and descending rows,
           k > 128 through radius_select; project_dist at a ragged N,
           d = 4096 and B = 1).  verify's distance pass must read each
           distinct candidate row once: its row count equals
           unique(cand).
  fused    the main path: ``index.search`` at B = 1, 16 and 64, k = 10,
           with every launch count set to 0 before and read after; ids
           identical to the plain path's; recall@10 against an exact
           brute force; the median batch time.
  profile  device time by CUDA kernel of one search at B = 1, 16 and 64
           (torch.profiler), verify's launches (its topk kernel's
           included) summed, and the card's idle share of the batch time.
  unfused  n = 4,096 (below the fused policy's 8,192), through the
           pairwise kernel's 2-D and per-query forms, its counts read the
           same way; ids identical to the plain path's.
  quant    ``flat-pq`` (PQ, 16 codebooks × 256 values) on the Deep1M
           twin: ``index.search`` at B = 1, 16 and 64, k = 10, counts set
           to 0 before and read after (adc_dist, pairwise_sq_dist,
           radius_select and verify_topk must each launch); ids identical
           to the plain path's; recall@10; the median batch time; the ADC
           kernel against its plain version at B = 64; profiles.
  cp       a clustered twin of the Audio set at its published shape
           (paper Table 3: n = 54,387, d = 192, float32; 40 clusters, 6
           active dimensions): ``flat`` ``cp_search(k=10)`` at cp_c = 4,
           γ = 1, counts read around it; pairs and counters identical to
           the plain path's; the pair_join kernel against its plain
           version on the sorted rows (pairs, counters, bands joined),
           one CUDA launch a call (counted from a trace) and no host sync
           (``torch.cuda.set_sync_debug_mode("error")``), a repeat call
           bit for bit;
           recall@10 against an exact float64 brute force on the card;
           the median cp_search time; a profile; then one ``flat-pq``
           cp_search (R = 1024 > 128 takes the plain join's route).
  stream   a streaming index (``segment_backend="flat"``, delta_threshold
           32,768, max_segments 4) over the Deep1M twin, churned for 24
           rounds (4,096 inserts from the same mixture, 32 deletes of
           churned rows; round 0 also deletes 64 seed rows; one eager
           flush() after round 20): after rounds
           8, 16 and 24, ``index.search`` at B = 1, 16, 64 with the counts
           read around it (topk_smallest and the three float kernels must
           launch), ids identical to a ``use_kernels=False`` twin fed the
           same operations, recall@10 against an exact float64 brute force
           over the live rows, the median batch time, segments, delta
           size, flushes and compactions; then one traced B = 64 search
           (facade / segment / delta / merge split, each kernel span's
           bytes, FLOPs and roofline fraction, ≤ 1.05) and profiles.
  stream_cp  the Audio twin inserted into a streaming index in batches of
           8,192 (delta_threshold 16,384): ``cp_search(10)``, pairs and
           counters identical to the ``use_kernels=False`` twin's, CP
           recall@10 against the exact pairs.
  project  ``ops.project_dist`` on the Deep1M twin with its own A (256 ×
           15) and B = 64 projected queries, against its plain version.
  kernels  the line {"kernels": [...]}: per kernel its launches on its
           path, its time by CUDA events and its device time by
           torch.profiler, its plain version's time, one PyTorch library
           call's, and its bound on the card from this run's inputs;
           pairwise_sq_dist has an entry at each of the float path's
           estimate shapes (B = 1, 16, 64, its launches at that B) and one
           at the delta scan's largest (64, 32,768, 256), its launches the
           stream's delta scans, each with its "shape";
           radius_select's entry also gives each of its launches' device
           time (the ladder, the two histogram passes, the compaction),
           verify_topk's its launches' (count, scan, scatter, distance,
           topk), its traffic model and the rows its distance pass read,
           pair_join's its CUDA launches and host syncs a call, its
           launch's device time, the time of its tile phases and of its
           plan-and-fold phases by the card's clock, its groups of bands
           and the tiles it computed and merged, and topk_smallest's a
           second timing at verify's shape (64, T, 10).
  pmtree   the paper's own index on the Audio twin: ``pmtree`` at c = 1.5,
           cp_c = 4, cp_T = 20,000 (A and the projections on the card,
           the PM-trees, Algorithms 2 and 4 on the host), ``search`` at
           B = 16 and ``cp_search(10)``; both trees, the ids, pairs and
           every counter identical to a CPU twin built from the card
           index's own A and projection; recall@10, CP recall@10 and the
           distance ratio; build seconds, ms a query, cp_search ms, rounds
           and distance computations, launches (none).
  pmtree_range  ``range_mask_device`` on the card against the host DFS on
           that ANN tree: 64 queries at Algorithm 2's first three radii
           (t·r_min, ×c, ×c²), slots equal outside ±1e-6 (relative) of the
           radius, the band's count, CUDA-event ms of the mask beside the
           DFS's host ms; ``range_query_device`` at T = βn + k.
  baselines  the nine §7 baselines built on the card: multiprobe, qalsh,
           srs, rlsh, lscan, lsb_tree on the Audio twin at B = 8 (the
           answer contract, mean distance ratio ≤ c, recall@10 > 0.2 but
           for multiprobe at its default w and srs, see ANN_BASELINES),
           lsb_tree, acp_p, mkcp, nlj ``cp_search(10)`` on its first
           4,096 rows (k real pairs ascending, distance ratio < 2.5);
           build and query seconds.
  stream_pmtree  a streaming index over the Audio twin with the default
           segment backend (pmtree): 32,768 seed rows, delta_threshold
           8,192, 4 rounds of 4,096 inserts and 32 deletes; after each,
           ``search`` at B = 16 held to a ``use_kernels=False`` twin (ids
           and counters identical, d² to the delta scan's tolerance), its
           launches (the delta scan's pairwise and topk, the merge's
           topk), recall@10 over the live rows, ms a query.
  stream_backends  streaming indexes whose segments are the reference's
           other backends: ``sharded-flat`` and ``sharded-flat-pq`` (4
           emulated shards inside each segment) seeded with the Deep1M
           twin's first 16,384 rows, then 4 rounds of the stream phase's
           churn (delta_threshold 8,000, max_segments 3: seals after
           rounds 2 and 4, the second compacting), searched at B = 1, 16,
           64 after rounds 3 and 4; ``lscan`` and ``qalsh`` segments on
           the Audio twin (32,768 seed rows, the rest in batches of 8,192),
           searched at B = 8 after each.  Each sealed segment's ids
           identical to its ``use_kernels=False`` twin's (the twin fed the
           same operations), the whole answer's and its counters too but
           where a delta row's norm-trick d² ties a segment row's within
           its rounding (the rows printed), each
           segment bit for bit a standalone index of its backend over its
           rows, the launches read (a shard's pairwise and verify a
           segment, ADC for pq, no radius_select: the sharded global
           threshold is a bisection over survivor counts; host segments
           none), recall@10 over the live rows.
  obs_trace  (after the ``kernels`` line) one warm traced call each of
           the fused float search at B = 64, ``flat-pq`` at B = 64 and the
           Audio ``cp_search(10)``: the span tree equal to
           EXPECTED_SPAN_TREES (the reference's), each ``kernel.*`` span's
           modelled bytes and FLOPs placed on the card's roofline
           (achieved fraction ≤ 1.05) and its wall ms beside the
           ``kernels`` line's device ms (≥ 0.9 × it where the shapes
           match), root coverage, the stage summary, and the Chrome-trace
           export validated and saved under ``build/``.
  quality  ``QualityAuditor.for_index`` on the 1M float index, all 64
           B = 64 answers sampled and audited on the card: audited =
           sampled − pending, its recall@10 within 1/640 of the fused
           phase's against float64, the ratio, the Lemma-3 CI coverage
           beside its nominal 1 − 2α, the calibration error, the audit's
           seconds.
  serve    the serving front end over the Deep1M twin:
           ``make_retrieval_step`` (flat, k = 16) and a degraded tier of
           the same keys behind sq8 codes (rerank 512) under
           ``RequestScheduler(ServeConfig(b_max=64, k_max=128))``, about
           2.4 GB of rows and codes on the card.  ``serve_closed``: C = 1,
           8, 64 clients submit and wait, 512 requests each, beside the
           naive loop (one ``step(q[None])`` a request): QPS, p50, p99, the
           median flush wall at B_pad = 64, recall@16 against float64 equal
           to the naive loop's.  ``serve_ragged``: 512 requests on the real
           clock, k in {1, 3, 10, 16, 50, 100, 128}, bursts of 64 between
           single trickles, deadlines of 2-20 ms; shapes ≤ the palette's 56.
           Every ok response of both passes equals its row of a direct
           search of its flushed batch, bit for bit, and each flush shape
           met at B_pad = 64 gives the plain path's ids; pairwise_sq_dist,
           radius_select and verify_topk must launch (``serve_kernels``).
           ``serve_hot``: 256 requests over 32 queries, zipf-like, cache
           off and on: p50 each, hit rate, and no launch in the pass of
           hits.  ``serve_overload``: 512 submits, no pump, max_queue 256,
           watermark 0.75: admitted, degraded, shed.  ``serve_chaos``: a
           seeded plan over serve.search, serve.degraded and serve.flush
           (p = 0.2) across 128 requests; no exception escapes, a fault
           fires.  ``serve_stream``: a streaming datastore (flat segments,
           262,144 seed rows, delta_threshold 32,768), 4 rounds of
           ``extend`` of 4,096 rows, ``evict`` of 32 seed rows and a batch
           of 64 inserted keys: each answers its own id at rank 0 with its
           payload, probes cached before ``extend`` are answered afresh
           after it, no evicted id answers, topk_smallest launches.  Every
           pass's statuses sum to what it submitted.
  sharded  (after serve) the sharded backends over an emulated mesh of
           4 shards on the card.  ``sharded``: ``sharded-flat`` on the
           Deep1M twin at B = 1, 16, 64, k = 10, counts set to 0 before
           each search and read after (pairwise_sq_dist and verify_topk 4
           a search, radius_select none): ids and distances identical to
           the ``flat`` index's, a differing row allowed only where its
           T-th and (T+1)-th projected distances tie; candidates_selected
           equal to the rows at or under each T-th projected distance
           (from flat's own estimate); ids identical to the same index run
           through the plain versions (``force="plain"``, no launch); the
           median batch ms beside flat's; ``sharded_profile`` the
           device time by CUDA kernel of one search at B = 1, 16, 64.
           ``sharded_group``: the index over a world-size-1 NCCL group (a
           file store under ``build/``) answers what the emulated P = 1
           mesh answers, bit for bit.
           ``sharded_pq``: ``sharded-flat-pq``, build seconds, 4 adc_dist
           launches a search, recall@10 ≥ 0.95 × flat-pq's, ids identical
           to its plain twin.  ``sharded_cp``: ``cp_search(10)`` on the
           Audio twin (cp_c = 4, γ = 1): pairs and distances identical to
           flat's, pairs_verified, tiles_pruned, max_shard_pairs, the
           wall and the peak device memory.  ``sharded_legacy``: the
           legacy ``sharded`` backend's recall@10 at B = 64, ≥ 0.9 ×
           flat's, and ``sharded_legacy_pad`` the NaN estimate of its
           +inf padding on the card and on the CPU (no check).
  durable  (last of the index phases) a streaming index over the Deep1M
           twin with ``durability = {"dir": "build/durable", "sync": True,
           "snapshot_every": 8}`` (flat segments, delta_threshold
           32,768): 8 rounds of 4,096 inserts and 32 deletes, a flush
           after round 6 (it snapshots), an error at ``stream.apply`` in
           round 7's insert, the index abandoned and ``recover()``ed on
           the card; then round 7's deletes, a snapshot, round 8, and an
           error at ``snapshot.commit``, recovered from the older
           snapshot and the WAL tail.  Each recovery is held to a twin fed
           the same ops without durability: ids identical, distances bit
           for bit at B = 64, n, segments, flushes and compactions equal;
           ``wal_records_total{op}`` equal to the ops issued.  It prints
           the disk's free bytes first, the WAL and snapshot bytes, the
           p50 of every WAL fsync (their count held to the
           ``wal_fsync_seconds`` histogram's), insert ms with ``sync`` beside the twin's, snapshot
           and recovery seconds, every ``RecoveryReport`` field and the
           Prometheus lines of the four resilience series, and removes
           the directory at the end.
  entry_points  (after durable) the twins of the repo's entry points on
           the index side, each ``main(["--device", "cuda"])`` in-process,
           loaded by path: ``examples/torch_quickstart.py`` (5,000 × 128:
           the facade's pmtree and flat ANN, pmtree CP against nlj, flat's
           cp_search), ``scripts/torch_check_api.py`` (16 backends on
           256 × 32 and the quant, cp, serve, quality and sharded gates)
           and ``scripts/torch_chaos_drill.py`` (seeds 0-4: durability
           and serve drills).  One line a twin: its rc, wall seconds, its
           own last printed line and its kernels' launches (counts set to
           0 before it, read after).  Checks: every rc 0, and the
           quickstart launched pairwise_sq_dist and pair_join.
  lm_examples  (after entry_points, on a card holding only the kernels)
           the twins of the LM examples, loaded by path.  (a) Each
           ``main(["--device", "cuda"])`` in-process at its own sizes,
           its ``run`` wrapped to keep its results, one line a twin (its
           seconds, last printed line and launches, counts set to 0
           before it): ``examples/torch_knn_serving.py`` (yi-6b's smoke
           config, a 32 × 64-token corpus's 2,016 hidden states served
           by a streaming datastore, grown by 8 × 63 and 16 evicted; the
           query's own key first with its payload, 2,504 live pairs, no
           evicted id back, pairwise_sq_dist and topk_smallest launched),
           ``examples/torch_long_context.py`` (dense and PM-LSH at T =
           256, m = 16 over an 8,192-row cache, 64-token prefill, 8
           greedy steps timed by CUDA events) and
           ``examples/torch_train_lm.py`` at its defaults (yi-100m, 125M
           parameters, 300 steps of batch 8 × 256, checkpoints every 100
           under ``build/train_lm``, removed after): 300 finite losses,
           the last below the first, the latest committed step 300, the
           median step ms and tokens/s beside the step's bound
           (``_train_bounds``).  (b) The smoke config in float32,
           parameters drawn once on the card and copied to the CPU: both
           twins' ``run`` on the card and on the CPU port, ids and tokens
           identical, distances and the first and last step's logits
           within 1e-4 of the largest.  (c) yi-6b at its full width
           (32 layers, d = 4096, bfloat16), one parameter set on the card
           at a time: the dense set through the knn twin (2,016 keys at
           d = 4096, its own key first) and long_context's dense run, then
           the PM-LSH set (T = 256, m = 16) through its LSH run; the first
           decode step's logits, dense against LSH, at correlation ≥ 0.995
           and relative L2 ≤ 0.05; printed: the last step's correlation,
           both ms/token beside the decode's bound (the weights' bytes at
           the HBM rate) and the peak bytes.

  lm_serve (after lm_examples, on a card the index phases have left) yi-6b
           at its full configuration (32 layers, d = 4096, 32 / 4 heads,
           hd = 128, d_ff = 11008, vocab 64,000, bfloat16, PM-LSH decode
           attention at T = 2048, m = 16) on parameters drawn by
           ``init_params`` from ``--seed`` on the card:
           ``launch.serve.serve_batch`` prefills 4 prompts of 4,096 tokens
           and decodes 32 greedy tokens (max_seq 4,128); the same steps
           again under CUDA events (prefill ms, each decode step's ms,
           their median, tokens/s) and profiled by CUDA kernel.  Checks:
           (a) every logit finite, every token in [0, 64000); (b) the
           decode of token 4,095 after a 4,095-token prefill, at T ≥
           kv_len, against the full forward's last logits (relative L2 ≤
           0.05, correlation ≥ 0.995); (c) on layer 0's prefilled cache,
           LSH decode attention at T = kv_len against dense attention
           (one bfloat16 ulp at the top binade; 1e-4 of the largest for a
           float32 query); (d) the seven smoke configs of the dense, moe
           and vlm families in float32 through ``serve_batch(gen=8)`` on
           the card and on the CPU port: tokens identical, logits within
           1e-4 of the largest.  Prints, unchecked, LSH at T = 2048
           against dense (relative error, coverage of each head's true
           top-32 keys), parameter, cache and peak bytes, and the bounds
           beside the times (decode: weights, gathered KV and pk at the
           HBM rate; prefill: bf16 matmul FLOP at 989 TFLOP/s, the f32
           chunked attention's at 67).
  lm_knn   the kNN-LM pattern of ``examples/knn_serving.py`` at that
           width: the final hidden states of the 4 × 4,096 prompt tokens
           (16,384 keys, d = 4096, float32) keyed to their next tokens,
           served by ``make_retrieval_step`` over ``flat`` (c = 1.5, m =
           15, k = 8), 64 datastore keys as queries.  Counts set to 0
           before the search and read after: one pairwise_sq_dist, one
           radius_select and one verify_topk launch; ids identical to the
           same index's ``use_kernels=False`` path; each query's own row
           first at distance ≤ 1e-3 with its payload, unless another key
           equals it (counted as a tie row).  verify_topk at d = 4096 held
           to its plain version, its rows read equal to the distinct rows
           of its query groups, its ms beside its bound and the library
           form's (gather + sum + ``topk``, as the kernels line's verify).

  lm_families  (after lm_knn, on the card it left) the hybrid, ssm and
           encdec families at their published widths and depth in
           bfloat16 on parameters drawn from ``--seed``, one model at a
           time: recurrentgemma-9b (38 layers of (rec, rec, local), d =
           4096, 16 / 1 heads, hd = 256, d_ff = 12288, vocab 256,000, rnn
           width 4096, window 2048) and xlstm-125m (12 layers of (mlstm,
           slstm), d = 768, 4 heads) on 4 prompts of 4,096 tokens,
           whisper-base (6 + 6 layers, d = 512, 8 heads) on 1,500 seeded
           frames and 4 prompts of 384 tokens; 32 greedy tokens each.
           Each model: ``serve_batch``, then the same steps under CUDA
           events (prefill ms, the median decode ms, tokens/s), peak
           bytes, a decode profile (and recurrentgemma's prefill
           profile), and the bounds (decode: the weights
           but the embedding table and the caches a token needs at the
           HBM rate; prefill: bf16 matmul FLOP at 989 TFLOP/s, float32
           FLOP at 67, bytes).  Checks: (a) every logit finite, every
           token in the padded vocabulary; (b) a prefill of all but the
           last 64 prompt tokens, then those 64 teacher-forced one step
           at a time: their logits against the full pass's (relative L2
           ≤ 0.05, correlation ≥ 0.995; the head on those 64 rows of the
           hidden states only) and every cache and recurrent state
           against a prefill of all the prompt (relative L2 ≤ 0.05); (c)
           the three smoke configs in float32 through ``serve_batch(gen=8)``
           on the card and on the CPU port: tokens identical, logits
           within 1e-4 of the largest.
  lm_shard (after lm_families, on the card it left) the LM's data axis:
           yi-6b (full configuration, bfloat16, seeded parameters) with
           its KV cache's sequence split over the host mesh's data axis,
           each step the PM-LSH tournament merge.  (a) A 4,096-token
           prompt at B = 1 through ``make_prefill`` into max_seq 8,192 on
           emulated meshes of data = 2, 4 and 8, then 8 greedy tokens
           through ``make_decode_step``: the sharded form taken, every
           logit finite, layer 0's gathered cache positions at every step
           equal to a plain per-shard recomputation (stable sort) of the
           same scores; the yi smoke config in float32 the same way on
           the card and on the CPU port (64-token prompt, max_seq 128):
           positions identical, logits within 1e-5 of the largest.  (a′)
           A 512-token chunk at position 4,096 after the prompt through
           ``make_decode_step`` (the shards' attention partials merged)
           on data = 2, 4, 8 and (2, 2), against one device's: layer 0's
           cache bit for bit (every layer's prompt rows too on (P, 1)),
           the last logits within lm_serve's bfloat16 bounds, the chunk's
           ms beside its bound (phase line ``lm_shard_chunk``).  (b)
           long_500k's shape: B = 1, max_seq 524,288, T = 2,048, m = 16,
           the cache filled from seeded draws on the card (pk through
           ``attention_apply``'s projection) to row 524,024, then at each
           of P = 1 (the unsharded form) and P = 2, 4, 8 a 256-token chunk
           there (rows 524,024-524,279, real k / v / pk; held to P = 1's as
           (a′) holds its chunk, its ms beside its bound) and 8 decode
           steps from 524,280 through ``make_decode_step``: ms a token (CUDA events, median), peak
           bytes, the bytes that cross a layer beside the k and v it
           holds, the decode's bound.  (c) the tournament over an NCCL
           group of one (file store under ``build/``) on layer 0's
           tensors of (b), bit for bit the emulated P = 1 form.
  lm_dp_train  (after lm_shard) data-parallel training: xlstm-125m at its
           published widths, 4 of its 12 layers (two (mlstm, slstm)
           units: its sLSTM scan makes a step launch-bound, and each
           emulated shard costs a whole one), float32 parameters, B = 4 ×
           4,096 tokens, from one seeded state: 3 steps of
           ``make_train_step`` on one device, then on emulated meshes of
           data = 2 and 4 and an NCCL group of one, each with 3 steps of
           ``make_compressed_train_step`` (the int8 error-feedback
           reduction): finite losses; the data-parallel step's first loss
           and gradient norm within 1e-5 (relative) of the one-device
           step's; on data = 2 and the group, each shard's int8 codes,
           scales and residuals of the first compressed step bit for bit
           the CPU port's on the same gradients copied to the host; step
           ms (CUDA events) and the bytes each reduction would send (int8
           codes, and the int32 psum as written, against float32).
  lm_train (after lm_dp_train) the training path.  (a) yi-6b at its
           published widths and depth, bfloat16 parameters and float32
           AdamW moments from ``--seed``, B = 1 × 4,096 tokens (train_4k's
           sequence), remat="unit", 4 steps through ``TrainLoop.run``:
           losses and gradient norms (all finite), step ms (CUDA events,
           the median of steps 2–4), tokens/s, peak bytes, a profiled
           step (busy ms, idle share, ms by kernel) and the bound
           (bfloat16 matmul FLOP at the tensor-core peak plus flash
           attention's float32 FLOP over the causal pairs at the float32
           peak, against the parameters' and moments' bytes), beside
           what remat's recompute and the masked chunks the port
           computes add to it.  (b)
           ``FlashAttention``'s dq / dk / dv at yi's attention shape (1,
           4,096, 32 / 4 heads, 128, causal, chunk 1,024) against
           float64 autograd through plain softmax attention: relative L2
           ≤ 1e-5 in float32, the bfloat16 case printed.  (c) the ten
           smoke configs in float32: 4 AdamW steps (lr 3e-3, no warm-up)
           on the card and on the CPU port from the same parameters,
           losses within 1e-5 relative, the last below the first.  (d) a
           smoke ``TrainLoop`` checkpointing every 2 steps under
           ``build/``, stopped at 4 and resumed to 6: its losses equal an
           unbroken run's.

  dryrun   (its cells run in lm_serve's and lm_train's state) the dry run
           (``repro_torch.launch.dryrun``) at mesh (1, 1), the meta
           device, held to the card on three cells: lm_train's step (yi-6b,
           B = 1 × 4,096, remat="unit", one more ``make_train_step`` step on
           the loop's state), lm_serve's prefill (B = 4 × 4,096 into
           max_seq 4,128) and one decode step at position 4,096 on its
           caches.  Checks: the FLOPs on meta equal ``FlopCounterMode``'s
           count around the step on the card; the argument bytes within
           0.1% of what the card allocated for the parameters, state and
           inputs; the card's peak over the predicted one (arguments +
           temp) inside ``DRYRUN_PEAK_BAND``.  Then one production cell,
           yi-6b decode_32k on the single-pod mesh (rank (0, 0) of 16 ×
           16), its record and seconds.

Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Where CUDA is unavailable it exits non-zero at once
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))



def _load_peaks() -> tuple[float, float]:
    """The card's HBM3 rate and float32 rate outside the tensor cores (the
    kernels here do float32 arithmetic on CUDA cores), from this
    checkout's ``repro_torch/obs/roofline.py``, the peaks' one source.
    It is loaded by its path: a script that compares two trees imports
    the other tree's package, which may predate the module."""
    import importlib.util

    path = os.path.join(ROOT, "src", "repro_torch", "obs", "roofline.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_roofline", path)
    roofline = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = roofline
    spec.loader.exec_module(roofline)
    peaks = roofline.get_peaks("cuda")
    return peaks.peak_bw, peaks.peak_flops


# a pause between two traced calls, longer than any gap inside one call
PAUSE_S = 0.005
PEAK_BYTES_PER_S, PEAK_F32_PER_S = _load_peaks()
N_POINTS, DIM = 1_000_000, 256  # Deep1M (paper Table 3)
AUDIO_N, AUDIO_D = 54_387, 192  # Audio (paper Table 3)
K = 10
BATCHES = (1, 16, 64)
STREAM_ROUNDS, STREAM_BATCH, STREAM_THRESHOLD = 24, 4096, 32768
STREAM_CHECKPOINTS = (8, 16, 24)
# a flush seals the whole delta, and churn deletes shrink it, so the
# threshold alone seals twice in 24 rounds (after rounds 9 and 18); one
# eager flush() gives the third seal and the count-triggered compaction
STREAM_FLUSH_AFTER = (20,)
# the paper's own index on the Audio twin: cp_T as examples/quickstart.py
# sets it; the CP baselines on a slice (nlj is an exact all-pairs join)
PMTREE_BATCH, PMTREE_CP_T = 16, 20_000
BASELINE_BATCH, BASELINE_CP_ROWS = 8, 4096
# E2LSH sets the bucket width w against the distances it must catch
# (Datar et al.: w ≈ 4R); Multi-Probe's default w = 4 suits the
# reference's unit-scale test data, and the Audio twin's 10-NN distance
# is ≈ 4.4 (the phase prints it), so its floor is held at w = 8; the
# default runs beside it with its recall printed.  SRS stops at its
# early-termination test (p_τ = 0.8107) with a c-approximate answer
# after ≈ 20 candidates here, so it is held to its guarantee (mean
# distance ratio ≤ c), not to a recall floor.
ANN_BASELINES = (("multiprobe", {"w": 8.0}), ("multiprobe", {}), ("qalsh", {}),
                 ("srs", {}), ("rlsh", {}), ("lscan", {}), ("lsb_tree", {}))
RECALL_FLOOR_EXEMPT = (("multiprobe", {}), ("srs", {}))
CP_BASELINES = ("lsb_tree", "acp_p", "mkcp", "nlj")
STREAM_PM_START, STREAM_PM_BATCH, STREAM_PM_ROUNDS, STREAM_PM_THRESHOLD = 32_768, 4096, 4, 8192
# segments over the reference's other backends (phase stream_backends):
# sharded-flat and sharded-flat-pq over an emulated mesh of 4 shards
# inside each segment, on the Deep1M twin's first 16,384 rows (cut from
# 1M: a sharded-flat-pq seal trains 4 codecs on the host, each on up to
# 16,384 rows of its shard, and the plain twin and the standalone check
# train their own; at larger seeds the pq half outran the time this
# phase may add to the run), then 4 rounds of the
# stream phase's churn at delta_threshold 8,000 and max_segments 3: seals
# after rounds 2 and 4, the second compacting, searched after rounds 3
# and 4; then lscan and qalsh segments on the Audio twin, 32,768 seed
# rows and the rest in batches of 8,192 (delta_threshold 8,192), B = 8
STREAM_BK_DEVICE, STREAM_BK_HOST = ("sharded-flat", "sharded-flat-pq"), ("lscan", "qalsh")
STREAM_BK_SEED, STREAM_BK_ROUNDS, STREAM_BK_THRESHOLD, STREAM_BK_CHECKPOINTS = (
    16_384, 4, 8000, (3, 4))
STREAM_BK_HOST_START, STREAM_BK_HOST_BATCH = 32_768, 8192
# the serve phase: the scheduler over the Deep1M twin at k = 16 (closed
# loop at C clients, beside one search a request), a ragged trace, a hot
# trace, an overload burst, a seeded chaos plan and a streaming datastore
SERVE_K, SERVE_B_MAX, SERVE_K_MAX, SERVE_RERANK = 16, 64, 128, 512
SERVE_CLIENTS, SERVE_CLOSED = (1, 8, 64), 512
SERVE_KS = (1, 3, 10, 16, 50, 100, 128)
SERVE_RAGGED, SERVE_HOT, SERVE_HOT_DISTINCT = 512, 256, 32
SERVE_OVERLOAD, SERVE_CHAOS = 512, 128
SERVE_STREAM_ROWS, SERVE_STREAM_ROUNDS, SERVE_STREAM_EVICT = 262_144, 4, 32
# the durable stream: 8 rounds of 4,096 inserts and 32 deletes, a flush
# after round 6 (it snapshots), the crash at stream.apply in round 7
DURABLE_ROUNDS, DURABLE_FLUSH_AFTER, DURABLE_CRASH_ROUND = 8, 6, 7
# the sharded backends: an emulated mesh of 4 shards on the one card
SHARDS = 4
# the LM phases: yi-6b (arXiv:2403.04652) at its published widths in
# bfloat16 on seeded parameters: 4 prompts of 4,096 tokens, 32 greedy
# tokens; then its hidden states as a kNN-LM datastore (k = 8, 64 keys as
# queries).  The card's dense bfloat16 tensor-core peak (NVIDIA's H100 SXM
# data sheet) bounds the prefill's matmuls.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "yi-6b", 4, 4096, 32
LM_SMOKE_ARCHS = ("yi_6b", "deepseek_67b", "mistral_large_123b", "minitron_8b",
                  "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b", "llama32_vision_11b")
LM_SMOKE_PROMPT, LM_SMOKE_GEN = 32, 8
LM_KNN_K, LM_KNN_QUERIES = 8, 64
PEAK_BF16_PER_S = 989e12
# tolerances: (b) the decode after a 4,095-token prefill against the full
# forward in bfloat16, through 32 layers of bfloat16 roundings on three
# attention routes (flash, chunked, LSH at T ≥ kv_len): relative L2 error
# and correlation of the last logits (≈ 1.1-1.5% at 8-16 layers of a narrow
# twin on the CPU); (c) LSH at T = kv_len against dense attention: one
# bfloat16 ulp at the top binade for a bfloat16 query, 1e-4 of the largest
# entry for a float32 one (4,096 keys summed in another order); (d) the
# smoke configs' float32 logits on the card against the CPU port's, 1e-4
# of the largest (cuBLAS and the CPU sum in other orders); a query's own
# datastore row answers at distance 0 (the difference form), held to 1e-3.
LM_CONSISTENCY_REL, LM_CONSISTENCY_CORR = 0.05, 0.995
LM_LSH_BF16_TOL, LM_LSH_F32_TOL = 2.0 ** -7, 1e-4
LM_SMOKE_TOL, LM_KNN_SELF_TOL = 1e-4, 1e-3
# the hybrid, ssm and encdec families, each at its published widths and
# depth in bfloat16 on seeded parameters: recurrentgemma-9b
# (arXiv:2402.19427) and xlstm-125m (arXiv:2405.04517) on 4 prompts of
# 4,096 tokens, whisper-base (arXiv:2212.04356) on 1,500 seeded frames and 4
# decoder prompts of 384 tokens (416 of its 448-token text context); 32
# greedy tokens each.  Check (b) prefills all but the last 64 prompt
# tokens and teacher-forces those one step at a time, held to LM_CONSISTENCY_*;
# (c) runs their smoke configs at LM_SMOKE_TOL.  The published widths:
# (layers, encoder layers, d, heads, kv heads, head dim, d_ff, vocab,
# rnn width, conv width, window).  The prefill is profiled where it keeps
# the card busy, recurrentgemma's: xlstm's is launch-bound (64 chunks × 6
# mLSTM layers), and tracing it cost more than the rest of its model.
LM_FAMILIES = (("recurrentgemma-9b", 4096, True), ("xlstm-125m", 4096, False),
               ("whisper-base", 384, False))
LM_FAMILY_WIDTHS = {
    "recurrentgemma-9b": (38, 0, 4096, 16, 1, 256, 12288, 256000, 4096, 4, 2048),
    "xlstm-125m": (12, 0, 768, 4, 4, 192, 0, 50304, 0, 4, 0),
    "whisper-base": (6, 6, 512, 8, 8, 64, 2048, 51865, 0, 4, 0),
}
LM_FAMILY_SMOKE = ("recurrentgemma_9b", "xlstm_125m", "whisper_base")
LM_FAMILY_TAIL = 64
# the LM profiles: a pause longer than any host stall inside an eager
# step, and for a decode step the fuller of two traces (one recorded only
# 118 of whisper's ≈ 1,000 kernels); a busy prefill's one trace shows a
# lost run as busy time short of its wall
LM_PROFILE_PAUSE_S, LM_PROFILE_TRACES = 0.25, 2
# the training path: yi-6b at its published widths and depth in bfloat16
# with float32 AdamW moments, B = 1 × S = 4,096 (train_4k's sequence; its
# global batch of 256 is a cluster's), TrainLoop's remat="unit", 4 steps
# through TrainLoop.run, no cut.  (b) flash attention's backward at yi's attention shape
# against float64 autograd through plain softmax attention, relative L2;
# (c) the ten smoke configs in float32, 4 AdamW steps on the card against
# the CPU port from the same parameters (losses relative); (d) a smoke
# TrainLoop checkpointing every 2 steps, stopped at 4, resumed to 6.
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 1, 4096, 4
LM_TRAIN_FLASH_TOL, LM_TRAIN_SMOKE_TOL = 1e-5, 1e-5
LM_TRAIN_SMOKE_STEPS, LM_TRAIN_RESUME_STEPS, LM_TRAIN_RESUME_EVERY = 4, (4, 6), 2
# the LM's data axis: yi-6b's sequence-sharded PM-LSH decode, (a) a
# 4,096-token prompt into max_seq 8,192 on emulated data = 2, 4, 8 and 8
# greedy tokens, its smoke config in float32 on the card and the CPU
# (positions identical, logits within 1e-5 of the largest); (b) long_500k's
# shape (B = 1, max_seq 524,288) from a cache drawn on the card to kv_len
# 524,280 (a 524,288-token prefill is out of a run's reach), 8 decode
# steps at P = 1, 2, 4, 8.  Then xlstm-125m (arXiv:2405.04517) trained
# data-parallel at its published widths with float32 parameters, B = 4 ×
# 4,096 (train_4k's sequence), 3 steps a form, the first step's loss and
# gradient norm within 1e-5 of the one-device step's.
LM_SHARD_PROMPT, LM_SHARD_MAX_SEQ, LM_SHARD_GEN, LM_SHARD_P = 4096, 8192, 8, (2, 4, 8)
LM_SHARD_SMOKE_PROMPT, LM_SHARD_SMOKE_MAX_SEQ, LM_SHARD_SMOKE_TOL = 64, 128, 1e-5
LM_LONG_SEQ, LM_LONG_KV, LM_LONG_GEN, LM_LONG_P = 524_288, 524_280, 8, (1, 2, 4, 8)
# a chunk past position 0 on a sequence-split cache (the decode step on a
# (1, S) block, the shards' attention partials merged): (a) 512 tokens at
# position 4,096 after the prompt on data = 2, 4, 8 and (2, 2), against
# the one-device form of the same chunk; (b) 256 tokens at 524,024 of
# long_500k's cache, whose synthetic fill is taken to end there, so the
# chunk writes rows 524,024-524,279 before the decode from 524,280, at
# P = 1 (the plain form), 2, 4, 8.  Layer 0 reads the same embedding on
# every form, so its cache rows must equal the one-device write bit for
# bit (a (P, 1) form's prefill rows too, in every layer: the one-device
# pass adds its masked chunks as exact zeros).  A deeper layer's input
# carries the merge's float32 order: the merged softmax partials differ
# from one pass in the last float32 bits (the CPU smoke configs: 4e-7 to
# 9e-7 of the largest logit), which bfloat16 roundings through the
# layers turn into the noise lm_serve bounds, so the last logits are held
# to LM_CONSISTENCY_REL / LM_CONSISTENCY_CORR against the one-device form.
LM_CHUNK, LM_CHUNK_MESHES, LM_LONG_CHUNK = 512, ((2, 1), (4, 1), (8, 1), (2, 2)), 256
LM_DP_ARCH, LM_DP_BATCH, LM_DP_SEQ, LM_DP_STEPS, LM_DP_P = "xlstm-125m", 4, 4096, 3, (2, 4)
LM_DP_TOL = 1e-5
# xlstm-125m's depth cut from 12 layers to 4 (two (mlstm, slstm) units),
# widths whole: the sLSTM's scan over 4,096 steps makes each shard's step
# launch-bound, so an emulated shard costs a whole step; at 12 layers the
# phase took 226.1 s of the script's 662.8 (NVIDIA H100 80GB HBM3, 700 W)
LM_DP_LAYERS = 4
# The LM's ('data', 'model') mesh (phase lm_tp): (a) qwen3-moe-30b-a3b
# at its published widths with 2 of its 48 layers, bfloat16 parameters and
# float32 AdamW moments, capacity_factor 1.25 (the config's), B = 4 × 4,096
# (train_4k's sequence), 3 steps a form — one device, emulated (2, 2) with
# FSDP and SP, emulated (1, 4) with SP, an NCCL group of one on the 2-D code path
# (FSDP at (1, 1)) — the first step's loss and gradient norm held to the
# one-device step's; (b) yi-6b at full width and depth, B = 4 prompts of
# 1,024 tokens into max_seq 2,048, 8 greedy tokens, at (1, 2), (1, 4) and
# (2, 2), and recurrentgemma-9b at (1, 2) (its MQA wk halved mid-head, the
# RG-LRU split on its width), the first logits held to one device's;
# (c) lm_shard (b)'s long_500k cache at (4, 2) and (2, 4): layer 0's
# positions and output bit for bit the data = 8 form.  The tolerances: a
# row-parallel output is the sum of M bfloat16 partial products where one
# device rounds one product, so the activations differ by bfloat16 ulps and
# a router near a tie may pick another expert at a dropping capacity —
# 1e-2 relative on the first loss, 5e-2 on the first gradient norm (the
# smoke config in bfloat16 on the CPU reads up to 1.4e-2 on the norm at
# (1, 4)).  The serve logits are held to a float32 twin of the same
# weights on one device: a form's first logits at most LM_TP_SERVE_NOISE
# times as far from it as the one-device bfloat16 logits are (both
# round their sums in bfloat16, the form M partial sums more), with
# lm_serve's correlation bound (LM_CONSISTENCY_CORR); chip call 1 read
# recurrentgemma-9b's (1, 2) logits 0.0546 of the largest off the
# one-device bfloat16 ones, where lm_families' two bfloat16 orders read
# 0.0388 (call 8, PR 26).
LM_TP_ARCH, LM_TP_LAYERS, LM_TP_BATCH, LM_TP_SEQ, LM_TP_STEPS = (
    "qwen3-moe-30b-a3b", 2, 4, 4096, 3)
LM_TP_LOSS_TOL, LM_TP_NORM_TOL = 1e-2, 5e-2
LM_TP_TRAIN_FORMS = (("emulated2x2_fsdp_sp", 2, 2, True), ("emulated1x4_sp", 1, 4, False))
LM_TP_SERVE = (("yi-6b", ((1, 2), (1, 4), (2, 2))), ("recurrentgemma-9b", ((1, 2),)))
LM_TP_PROMPT, LM_TP_MAX_SEQ, LM_TP_GEN = 1024, 2048, 8
LM_TP_SERVE_NOISE = 2.0
LM_TP_LSH = ((4, 2), (2, 4))
# the dry run (repro_torch.launch.dryrun) at mesh (1, 1) held to the card
# on the cells it runs on one device: lm_train's step, lm_serve's prefill
# and one decode step.  The FLOPs on meta equal FlopCounterMode's count
# on the card; the argument bytes within DRYRUN_ARG_TOL (relative) of the
# card's allocation for the parameters, state and inputs; the card's
# peak over the predicted one (arguments + temp) inside DRYRUN_PEAK_BAND,
# written down before the first chip run (the card adds cuBLAS's
# workspace and kernel-internal scratch, 512-byte rounding; the meta run
# sees every other allocation and free).  Then one production cell.
DRYRUN_ARG_TOL = 1e-3
DRYRUN_PEAK_BAND = (0.98, 1.05)
DRYRUN_PRODUCTION = ("yi-6b", "decode_32k", "single")
# the span trees of one traced call of each path, (name, parent index):
# the reference's trees (a CPU test holds them to repro's)
EXPECTED_SPAN_TREES = {
    "fused": [("index.search", -1), ("ann.query", 0), ("ann.project", 1),
              ("ann.estimate", 1), ("kernel.pairwise_sq_dist", 3), ("ann.select", 1),
              ("kernel.radius_select", 5), ("ann.verify", 1), ("kernel.verify_topk", 7),
              ("ann.answer", 1)],
    "flat-pq": [("index.search", -1), ("quant.query", 0), ("quant.estimate", 1),
                ("kernel.pairwise_sq_dist", 2), ("quant.select", 1),
                ("kernel.radius_select", 4), ("quant.rerank", 1), ("kernel.adc_dist", 6),
                ("kernel.radius_select", 6), ("quant.verify", 1), ("kernel.verify_topk", 9)],
    "cp": [("index.cp_search", -1), ("cp.query", 0), ("cp.project", 1), ("cp.sort", 1),
           ("cp.join", 1), ("kernel.pair_join", 4), ("cp.reverify", 1)],
}
# each kernel span of those trees, in order: the kernels-line entry (name,
# shape) that timed the same kernel at the same shape, or None (flat-pq's
# R-select and its verify of R rows run at shapes the line does not time)
KERNEL_LINE_SHAPES = {
    "fused": [("pairwise_sq_dist", [64, N_POINTS, 15]), ("radius_select", None),
              ("verify_topk", None)],
    "flat-pq": [("pairwise_sq_dist", [64, N_POINTS, 15]), ("radius_select", None),
                ("adc_dist", None), None, None],
    "cp": [("pair_join", None)],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def make_clustered_twin(n: int, d: int, seed: int, clusters: int = 60,
                        active: int = 12, rows_seed: int | None = None) -> np.ndarray:
    """Clustered Gaussian mixture with low-rank spread inside each
    cluster (local intrinsic dimension ≈ ``active``), the recipe of the
    repo's Deep twin (benchmarks/datasets.py), at full scale.  The
    mixture comes from ``seed``; ``rows_seed`` draws other rows of the
    same mixture."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 6.0
    basis = rng.normal(size=(clusters, active, d)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=-1, keepdims=True)
    if rows_seed is not None:
        rng = np.random.default_rng(rows_seed)
    asg = rng.integers(0, clusters, n)
    coeff = rng.standard_normal((n, active), dtype=np.float32)
    pts = rng.standard_normal((n, d), dtype=np.float32)
    pts *= 0.05  # a pinch of full-rank noise: distances are non-degenerate
    for c in range(clusters):
        rows = np.flatnonzero(asg == c)
        pts[rows] += centers[c] + coeff[rows] @ basis[c]
    return pts


def make_queries(data: np.ndarray, count: int, seed: int) -> np.ndarray:
    """Dataset points with a small jitter (paper §7.1)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, data.shape[0], count)
    sample = data[rng.integers(0, data.shape[0], min(data.shape[0], 100_000))]
    scale = 0.05 * np.linalg.norm(sample.std(axis=0)) / np.sqrt(data.shape[1])
    jitter = rng.standard_normal((count, data.shape[1]), dtype=np.float32)
    return (data[ids] + jitter * scale).astype(np.float32)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` timings by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def warm_trace(torch, pause: float = PAUSE_S) -> None:
    """Small kernels, then a pause: the first launches of a trace were
    seen to go unrecorded, so a trace starts with these and keeps what
    follows the pause."""
    x = torch.zeros(256, device="cuda")
    for _ in range(4):
        x += 1
    torch.cuda.synchronize()
    time.sleep(pause)


def after_pause(prof, pause: float = PAUSE_S) -> list:
    """The kernels and copies of a trace (no host events) in launch order,
    from the first one after its last pause (a gap of 0.8 ``pause``: a
    call whose host stalls that long inside needs a longer one)."""
    evts = sorted((e for e in prof.events()
                   if e.cpu_time_total == 0 and (e.self_device_time_total or 0) > 0),
                  key=lambda e: e.time_range.start)
    cut = 0
    for i in range(1, len(evts)):
        if evts[i].time_range.start - evts[i - 1].time_range.end > 0.8 * pause * 1e6:
            cut = i
    return evts[cut:]


def traced_calls(torch, fn, reps: int = 5) -> list:
    """``reps`` calls of ``fn()`` (after a warm-up call), each traced by
    torch.profiler: per call, its kernels and copies in launch order as
    (name, device ms).  Each trace runs ``fn()`` twice with a pause
    between and keeps the second."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_trace(torch)
            fn()
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
            fn()
            torch.cuda.synchronize()
        runs.append([(e.name, e.self_device_time_total / 1e3) for e in after_pause(prof)])
    return runs


def device_ms(torch, fn, reps: int = 5) -> float:
    """Device time of one ``fn()``: the summed device time of its kernels
    and copies, the median over ``reps`` traced calls.  Beside the event
    time it shows how much of a launch-bound call is host work."""
    return statistics.median(sum(ms for _, ms in run) for run in traced_calls(torch, fn, reps))


def launch_ms(torch, fn, match: tuple, reps: int = 5) -> list:
    """(name, device ms) of each kernel or copy of one ``fn()`` whose name
    holds one of ``match``, in launch order: the median over the traced
    calls that show the most common number of them (a trace may miss a
    launch, or keep a second call)."""
    runs = [[(n, ms) for n, ms in run if any(m in n for m in match)]
            for run in traced_calls(torch, fn, reps)]
    size = statistics.mode(len(run) for run in runs)
    full = [run for run in runs if len(run) == size]
    return [(full[0][i][0], statistics.median(run[i][1] for run in full))
            for i in range(size)]


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time on the card in ms, and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_syncs(torch, fn) -> int:
    """Host syncs one ``fn()`` makes, as PyTorch's sync debug mode sees
    them (a warning each)."""
    import warnings

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profile_call(torch, fn, wall_ms: float, rows: int = 16, pause: float = PAUSE_S,
                 traces: int = 1) -> dict:
    """Device time by CUDA kernel of one ``fn()`` (after a warm-up call),
    by torch.profiler, and the share of the untraced wall time
    ``wall_ms`` in which the card ran no kernel (tracing itself slows the
    host, so the traced window overstates it).  With ``traces`` > 1 the
    call is traced that many times and the trace that recorded the most
    kernels is kept: a trace may miss a run of launches.  verify_topk answers
    through the topk kernel from C: the one or two topk launches right
    after a verify distance pass are verify's, listed as
    ``verify_topk/topk_kernel``, and ``verify_topk_ms`` sums verify's
    kernels (its two small memsets aside)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_trace(torch, pause)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        evts = after_pause(prof, pause)
        if best is None or len(evts) > len(best[0]):
            best = (evts, traced_ms)
    kept, traced_ms = best
    by_name, verify_ms, after_verify = {}, 0.0, 0
    for e in kept:
        name, ms = e.name, e.self_device_time_total / 1e3
        name = name.replace("void ", "").replace("(anonymous namespace)::", "")
        if "verify_" in name:
            verify_ms += ms
            after_verify = 2 if "verify_dist" in name else 0
            name = name.split("(")[0]
        elif "topk_kernel" in name and after_verify:
            verify_ms += ms
            after_verify -= 1
            name = "verify_topk/topk_kernel"
        else:
            after_verify = 0
        row = by_name.setdefault(name[:80], {"name": name[:80], "calls": 0, "device_ms": 0.0})
        row["calls"] += 1
        row["device_ms"] += ms
    table = sorted(by_name.values(), key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in table)
    return {"traced_wall_ms": traced_ms, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "verify_topk_ms": verify_ms,
            "device_ops": sum(r["calls"] for r in table), "by_kernel": table[:rows]}


def profiles(torch, phase: str, search, batch_ms: dict) -> None:
    """One profile line per batch size: the full table at the largest,
    the first rows at the others."""
    for B in sorted(batch_ms):
        emit({"phase": phase, "B": B, **profile_call(
            torch, lambda: search(B), batch_ms[B], rows=16 if B == max(batch_ms) else 6)})


def verify_traffic_bytes(n: int, d: int, B: int, Tc: int, k: int, uniq: int, E: int) -> int:
    """What csrc/verify.cu moves for one group of queries, each array
    counted where it crosses HBM: each distinct row once; cand read by
    the count and by the scatter; the n counts zeroed, counted into (read
    and written), read by two scan passes and rewritten as offsets; the
    compact row list (id, start) written and read; dist written whole by
    the count (ranks, +inf at padding), its ranks read by the scatter, the
    d² written by the distance pass and the whole read by the topk kernel;
    entries written and read; the queries and the answer."""
    W = max(Tc, k)
    return (4 * uniq * d + 2 * 4 * B * Tc + 6 * 4 * n + 2 * 8 * uniq
            + 4 * B * W + 4 * E + 4 * E + 4 * B * W + 2 * 4 * E + 4 * B * d + 8 * B * k)


def exact_knn(torch, x, q, k: int) -> np.ndarray:
    """Rows of the k nearest rows of x to each query, in float64 on the
    card."""
    x64, q64 = x.double(), q.double()
    d2 = (q64 * q64).sum(1, keepdim=True) + (x64 * x64).sum(1)[None] - 2.0 * q64 @ x64.T
    return torch.topk(d2, k, largest=False).indices.cpu().numpy()


def exact_closest_pairs(torch, x, k: int, rows: int = 2048) -> set:
    """The k closest pairs of x's rows (i < j), by blocks of rows on the
    card in float64."""
    x64 = x.double()
    norms = (x64 * x64).sum(1)
    n = x64.shape[0]
    cols = torch.arange(n, device=x.device)
    best_v, best_p = [], []
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        d2 = norms[r0:r1, None] + norms[None, :] - 2.0 * (x64[r0:r1] @ x64.T)
        d2 = torch.where(cols[None, :] > cols[r0:r1, None], d2, float("inf"))
        v, flat = torch.topk(d2.reshape(-1), k, largest=False)
        best_v.append(v)
        best_p.append(torch.stack([flat // n + r0, flat % n], 1))
    v, p = torch.cat(best_v), torch.cat(best_p)
    top = torch.topk(v, k, largest=False).indices
    return {tuple(pair) for pair in p[top].tolist()}


def select_edge_rows(rng) -> list:
    """(name, d, tau0, T) numpy rows for radius_select's edges:
    brackets that collapse (lo == hi), values near FLT_MAX where lo + hi
    overflows to +inf mids with real values above hi, +inf and NaN
    entries, ties on the tree's mids."""
    rows = []
    d = np.zeros((2, 600), np.float32)
    d[1] = np.inf
    d[1, :50] = rng.uniform(1.0, 2.0, 50)
    rows.append(("collapsed", d, np.ones(2, np.float32), 100))
    d = rng.uniform(1e38, 3.4e38, size=(6, 2000)).astype(np.float32)
    d[:, :100] = rng.uniform(0.0, 1e37, size=(6, 100))
    d[4, 100:600] = rng.uniform(1e38, 1.69e38, 500)
    d[4, 600:900] = np.float32(1.703e38)
    d[4, 900:] = rng.uniform(1.75e38, 3.4e38, 1100)
    d[5, 100:] = np.inf
    d[5, :100] = rng.uniform(2e38, 3.4e38, 100)
    rows.append(("near_flt_max", d,
                 np.array([2.9e38, 2.2e38, 1.5e38, 4e37, 1.703e38, 1e36], np.float32), 800))
    d = (rng.normal(size=(3, 2 * 4096 + 77)) ** 2).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = np.inf
    d[rng.random(d.shape) < 0.1] = np.nan
    d[2, :-100] = np.inf
    rows.append(("inf_nan", d, np.full(3, 0.02, np.float32), 150))
    d = rng.integers(0, 8, size=(3, 3000)).astype(np.float32)
    rows.append(("small_integers", d, np.full(3, 0.35, np.float32), 300))
    return rows


def edge_parity(torch, dev, ref, ops, kpair, ksel, kver, ktopk, kproj) -> int:
    """The kernels against their plain versions at the edge shapes of the
    CPU tests; returns the number of cases checked."""
    from repro_torch.kernels import counts

    g = torch.Generator(device=dev).manual_seed(7)
    cases = 0
    for B in (1, 5):
        for N in (100, 300):
            for d in (15, 64):
                q = torch.randn((B, d), generator=g, device=dev)
                x = torch.randn((N, d), generator=g, device=dev)
                check(torch.allclose(kpair.pairwise_sq_dist(q, x),
                                     ref.pairwise_sq_dist(q, x), rtol=1e-5, atol=1e-4),
                      f"pairwise_sq_dist edge ({B}, {N}, {d})")
                cases += 1
    for B, N, d in ((4, 33, 16), (3, 50, 256)):
        q = torch.randn((B, d), generator=g, device=dev)
        x = torch.randn((B, N, d), generator=g, device=dev)
        check(torch.allclose(kpair.pairwise_sq_dist_rows(q, x),
                             ref.pairwise_sq_dist(q, x), rtol=1e-5, atol=1e-5),
              f"pairwise_sq_dist_rows edge ({B}, {N}, {d})")
        cases += 1
    for B, N, T, scale in ((1, 100, 7, 1.0), (7, 700, 120, 1.0), (5, 300, 1, 1.0),
                           (2, 500, 30, 1e-9), (2, 500, 30, 1e9)):
        dd = torch.randn((B, N), generator=g, device=dev) ** 2 * 3
        tau0 = dd.mean(1) * max(T / N, 1e-3) * scale
        got = ksel.radius_select(dd, tau0, T)
        want = ref.radius_select_exact(dd, tau0, T)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"radius_select edge ({B}, {N}, {T}, {scale})")
        cases += 1
    for name, dd, tau0, T in select_edge_rows(np.random.default_rng(9)):
        dd, tau0 = torch.from_numpy(dd).to(dev), torch.from_numpy(tau0).to(dev)
        got = ksel.radius_select(dd, tau0, T)
        want = ref.radius_select_exact(dd, tau0, T)
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"radius_select edge {name}")
        cases += 1
    tie = torch.full((1, 600), 5.0, device=dev)
    tie[0, 597:] = 0.5
    got = ksel.radius_select(tie, torch.ones(1, device=dev), 10)
    want = ref.radius_select_exact(tie, torch.ones(1, device=dev), 10)
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and int(got[2][0]) == 600,
          "radius_select tie cluster")
    _, idx = ops.radius_select(tie, 10, T_pad=100)  # the ordered route
    check(set(idx[0, :3].tolist()) == {597, 598, 599}, "radius_select tie cluster, ordered")
    # 10,000 tied values past the band buffer: resolved over the whole row
    wide = torch.randn((2, 20000), generator=g, device=dev) ** 2 + 2.0
    wide[:, 5000:15000] = 1.5
    half = torch.full((2,), 0.5, device=dev)
    *got, stats = ksel.radius_select(wide, half, 2000, stats=True)
    want = ref.radius_select_exact(wide, half, 2000)
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and stats[:, 2].tolist() == [1, 1],
          f"radius_select wide tie cluster (stats {stats.tolist()})")
    cases += 2
    # verify: padding, k > Tc, exact ties, a row named by every query and
    # twice in one list, queries past one group (B = 130), a width past
    # the registers' (d = 600, read from global memory per entry), a NaN
    # row; tolerance: ids exact, d² rtol 1e-5 (both sum the difference
    # form, in another order); rows read = distinct ids a group
    rng = np.random.default_rng(8)
    for B, n, d, Tc, k, pad in ((1, 50, 8, 10, 1, 0), (7, 129, 33, 64, 10, 20),
                                (2, 40, 12, 6, 10, 2), (16, 5000, 64, 4000, 128, 100),
                                (130, 20000, 256, 3000, 10, 0), (8, 3000, 600, 1000, 10, 0)):
        data = torch.randn((n, d), generator=g, device=dev)
        q = torch.randn((B, d), generator=g, device=dev)
        cand = torch.from_numpy(np.stack([rng.permutation(n)[:Tc] for _ in range(B)])
                                .astype(np.int32)).to(dev)
        if pad:
            cand[:, Tc - pad:] = -1
        if B == 7:  # exact ties: duplicate rows, the earlier position answers first
            data[9], data[8] = data[3], data[4]
        if B == 16:  # a row in every list, twice in the first; a NaN row
            cand[:, 1] = 3
            cand[0, 7] = 3
            data[11, 5] = float("nan")
            cand[:, 2] = 11
        gv, gi, read = kver.verify_topk(data, q, cand, k, rows_read=True)
        wv, wi = ref.verify_topk(data, q, cand, k)
        G = kver.group_size(B, d)
        want_read = sum(int(torch.unique(c[c >= 0]).numel()) for c in cand.split(G))
        check(torch.equal(gi, wi) and int(read) == want_read
              and torch.allclose(gv, wv, rtol=1e-5, atol=1e-5, equal_nan=True),
              f"verify_topk edge ({B}, {n}, {d}, {Tc}, {k}, {pad})")
        cases += 1
    # topk: k = 1 and 128, a row shorter than one 2,048-key chunk, rows
    # not a multiple of it, equal values, a row with two finite entries,
    # ascending and descending rows (the threshold filter's best and worst
    # case); tolerance: exact, values bit for bit
    for B, N, k, kind in ((3, 5000, 1, "rand"), (5, 9000, 128, "rand"),
                          (4, 700, 10, "rand"), (2, 3 * 2049 + 5, 33, "rand"),
                          (3, 4100, 16, "equal"), (3, 3000, 8, "few_finite"),
                          (4, 50000, 10, "ascending"), (4, 50000, 10, "descending")):
        dd = torch.rand((B, N), generator=g, device=dev)
        if kind in ("ascending", "descending"):  # no key passes / every key passes
            dd = torch.sort(dd, 1, descending=kind == "descending").values
        if kind == "equal":
            dd.fill_(7.0)
        elif kind == "few_finite":  # the sort answers 0, 1, ... in the +inf slots
            dd[0] = float("inf")
            dd[0, 5], dd[0, N - 1] = 2.0, 1.0
        gv, gi = ktopk.topk_smallest(dd, k)
        wv, wi = ref.topk_smallest(dd, k)
        check(torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32)),
              f"topk_smallest edge ({B}, {N}, {k}, {kind})")
        if kind == "few_finite":
            check(gi[0, :4].tolist() == [N - 1, 5, 0, 1], "topk_smallest: +inf slots")
        cases += 1
    dd = torch.rand((4, 20000), generator=g, device=dev)
    routed = counts.ROUTES["topk_smallest.k_over_128"]
    gv, gi = ops.topk_smallest(dd, 300)
    wv, wi = ref.topk_smallest(dd, 300)
    check(counts.ROUTES["topk_smallest.k_over_128"] == routed + 1,
          "topk_smallest at k = 300 did not take the radius_select route")
    check(torch.equal(gi, wi) and torch.equal(gv, wv), "topk_smallest k = 300")
    cases += 1
    # project_dist: N not a multiple of the 128-point tile, d = 4096 (A
    # staged in 128 slabs), B = 1, B past the 64 staged queries, m = 16, 20
    for B, N, d, m in ((5, 1000, 64, 15), (1, 4099, 4096, 15), (7, 777, 33, 16),
                       (70, 3000, 96, 20)):
        x = torch.randn((N, d), generator=g, device=dev)
        a = torch.randn((d, m), generator=g, device=dev)
        qp = torch.randn((B, d), generator=g, device=dev) @ a
        got = kproj.project_dist(x, a, qp)
        tol = 1e-5 * ((qp * qp).sum(1)[:, None] + ((x @ a) ** 2).sum(1)[None]) + 1e-6
        check(bool(((got - ref.project_dist(x, a, qp)).abs() <= tol).all()),
              f"project_dist edge ({B}, {N}, {d}, {m})")
        cases += 1
    return cases


def quant_phase(torch, dev, data, queries, exact, seed: int) -> dict:
    """flat-pq on the Deep1M twin: the quantized main path, its checks,
    and what the kernels line needs of the ADC kernel."""
    from repro_torch.core import candidate_budget, select_seed
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import adc as kadc
    from repro_torch.kernels import counts, ops, ref

    cfg = IndexConfig(backend="flat-pq", seed=seed)
    t0 = time.perf_counter()
    pq = build_index(data, cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    impl = pq.impl
    T = candidate_budget(impl.params, impl.n, K)

    counts.reset()
    answers = {B: pq.search(queries[:B], K) for B in BATCHES}
    used = counts.snapshot()
    for name in ("adc_dist", "pairwise_sq_dist", "radius_select", "verify_topk"):
        check(used["launches"][name] > 0, f"quant path never launched {name}")
    # the rerank budget R, as the facade chose it: it verifies R rows a query
    R = answers[1].stats.candidates_verified
    plain = build_index(data, cfg.with_options(use_kernels=False), device=dev)
    check(torch.equal(pq.codes, plain.codes), "quant path: the plain index's codes differ")
    for B in BATCHES:
        check(np.array_equal(answers[B].indices, plain.search(queries[:B], K).indices),
              f"quant path at B={B}: kernel ids differ from the plain path's")
    del plain
    got = answers[max(BATCHES)].indices
    recall = float(np.mean([len(set(got[i]) & set(exact[i])) / K for i in range(len(got))]))
    check(recall > 0.5, f"recall@10 {recall} on the quant path")
    batch_ms = {}
    for B in BATCHES:
        qB = queries[:B]
        batch_ms[B] = time_ms(torch, lambda: pq.search(qB, K), reps=7, warmup=1)

    # the ADC kernel at the main path's shapes: B = 64 queries, T candidates
    q64 = torch.from_numpy(queries).to(dev)
    d2p = ops.pairwise_sq_dist(impl.family.project(q64), impl.projected)
    _, cand = ops.radius_select(d2p, T, tau0=select_seed(d2p, T, impl.m))
    ccodes = pq.codes[cand.to(torch.int64)]
    lut = pq.codec.lookup_tables(q64)
    got_adc = kadc.adc_dist(ccodes, lut)
    want_adc = ref.adc_dist(ccodes, lut)
    adc_err = float((got_adc - want_adc).abs().max())
    # tolerance: exact; both add the same table entries in slot order
    check(torch.equal(got_adc, want_adc), f"adc_dist: max |diff| {adc_err}, expected 0")
    idx = ccodes.permute(0, 2, 1).to(torch.int64)  # the library call's index form
    B, S, V = lut.shape
    emit({"phase": "quant", "n": impl.n, "d": impl.d, "codebooks": S, "values": V,
          "T": T, "R": R, "build_seconds": build_s, "launches": used["launches"],
          "routes": used["routes"], "ids_identical_to_plain": True,
          "recall_at_10": recall, "queries_for_recall": len(got),
          "adc_max_abs_err": adc_err, "code_bytes": pq.codes.numel(),
          "median_batch_ms": {str(b): batch_ms[b] for b in BATCHES},
          "queries_per_s": {str(b): b / batch_ms[b] * 1e3 for b in BATCHES}})
    profiles(torch, "quant_profile", lambda B: pq.search(queries[:B], K), batch_ms)
    return {"index": pq, "recall": recall, "launches": used["launches"]["adc_dist"],
            "err": adc_err,
            "fn": lambda: kadc.adc_dist(ccodes, lut),
            "plain": lambda: ref.adc_dist(ccodes, lut),
            "library": lambda: torch.gather(lut, 2, idx).sum(1),
            "bytes": ccodes.numel() + 4 * lut.numel() + 4 * B * ccodes.shape[1],
            "ops": ccodes.numel()}


def cp_phase(torch, dev, seed: int) -> dict:
    """Closest pair on the Audio twin: the flat cp_search path, its
    checks, and what the kernels line needs of the pair_join kernel."""
    from repro_torch.core.cp_fused import cp_threshold2
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts, ref
    from repro_torch.kernels import pair_join as kjoin

    audio = make_clustered_twin(AUDIO_N, AUDIO_D, seed + 4, clusters=40, active=6)
    cfg = IndexConfig(backend="flat", seed=seed)
    index = build_index(audio, cfg, device=dev)
    index.cp_search(K)  # warm-up
    counts.reset()
    res = index.cp_search(K)
    used = counts.snapshot()
    check(used["launches"]["pair_join"] > 0, "cp path never launched pair_join")
    t0 = time.perf_counter()
    plain = build_index(audio, cfg.with_options(use_kernels=False), device=dev).cp_search(K)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(res.pairs, plain.pairs), "cp path: pairs differ from the plain path's")
    check((res.stats.pairs_verified, res.stats.tiles_pruned)
          == (plain.stats.pairs_verified, plain.stats.tiles_pruned),
          f"cp path: counters {res.stats} differ from the plain path's {plain.stats}")
    exact = exact_closest_pairs(torch, index.impl.data, K)
    recall = len(exact & {tuple(p) for p in res.pairs.tolist()}) / K
    check(recall >= 0.5, f"cp recall@10 {recall}")
    cp_ms = time_ms(torch, lambda: index.cp_search(K), reps=5, warmup=1)

    # the kernel against its plain version on the sorted rows of this run
    key = index.impl.projected[:, 0]
    order = torch.sort(key, stable=True).indices
    xs, ks = index.impl.data[order].contiguous(), key[order].contiguous()
    thresh2 = cp_threshold2(cfg.cp_c, cfg.m, 1.0)
    kv, ki, kj, kstats = kjoin.pair_join(xs, ks, K, thresh2=thresh2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pv, pi, pj, pstats = ref.pair_join(xs, ks, K, thresh2=thresh2)
    torch.cuda.synchronize()
    join_plain_ms = (time.perf_counter() - t0) * 1e3
    check(kstats.tolist() == pstats.tolist(),
          f"pair_join: counters {kstats.tolist()} differ from the plain version's "
          f"{pstats.tolist()}")
    # tolerance: the norm trick's float32 cancellation on |xi|² + |xj|²
    # (≈ 2·max|x|²) times 1e-6, as the card tests hold it
    join_tol = 1e-6 * 2 * float((xs * xs).sum(1).max())
    join_err = float((kv - pv).abs().max())
    check(join_err <= join_tol, f"pair_join: d² max |diff| {join_err} > {join_tol}")
    # the kernel's pairs, re-verified in the difference form: its d² are
    # theirs and the pair set is the plain version's (ranks among
    # near-equal d² may differ: the kernel and cuBLAS round the cross
    # term differently)
    real = ki >= 0
    diff = xs[ki[real].long()] - xs[kj[real].long()]
    reverify_err = float((kv[real] - (diff * diff).sum(1)).abs().max())
    check(reverify_err <= join_tol,
          f"pair_join: d² {reverify_err} from the difference form > {join_tol}")
    check(set(zip(ki.tolist(), kj.tolist())) == set(zip(pi.tolist(), pj.tolist())),
          "pair_join: pair set differs from the plain version's")
    join_identical = torch.equal(ki, pi) and torch.equal(kj, pj)
    pairs_verified, tiles_pruned, bands = kstats.tolist()

    # one cooperative launch and no host sync a call, and a repeat call
    # bit for bit; the sweep's own account of its phases by the card's clock
    def join():
        return kjoin.pair_join(xs, ks, K, thresh2=thresh2)

    *again, sweep = kjoin.pair_join(xs, ks, K, thresh2=thresh2, sweep=True)
    check(all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                          b.view(torch.int32) if b.dtype == torch.float32 else b)
              for a, b in zip((kv, ki, kj, kstats), again)),
          "pair_join: a repeat call differs from the first, bit for bit")
    tile_ns, fold_ns, groups, tiles_computed, merges = sweep.tolist()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        join()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = host_syncs(torch, join)
    check(syncs == 0, f"pair_join: {syncs} host syncs a call")
    traced = traced_calls(torch, join)
    kernels = [[(n, ms) for n, ms in run if "emcpy" not in n and "emset" not in n]
               for run in traced]
    cuda_launches = statistics.mode(len(run) for run in kernels)
    check(cuda_launches == 1 and all("pair_join_kernel" in run[0][0]
                                     for run in kernels if len(run) == 1),
          f"pair_join: {[[n for n, _ in run] for run in kernels]} CUDA launches a call")
    launch_device_ms = statistics.median(run[0][1] for run in kernels if len(run) == 1)
    n_ti = -(-AUDIO_N // 128)
    tiles = n_ti * (n_ti + 1) // 2
    emit({"phase": "cp", "n": AUDIO_N, "d": AUDIO_D, "k": K, "cp_c": cfg.cp_c, "gamma": 1.0,
          "thresh2": thresh2, "launches": used["launches"], "routes": used["routes"],
          "pairs_identical_to_plain": True, "counters_identical_to_plain": True,
          "join_positions_identical_to_plain": join_identical,
          "join_repeat_identical": True, "join_cuda_launches": cuda_launches,
          "join_host_syncs": syncs,
          "pairs_verified": pairs_verified, "tiles_pruned": tiles_pruned, "tiles": tiles,
          "bands_joined": bands, "bands": n_ti, "all_pairs": AUDIO_N * (AUDIO_N - 1) // 2,
          "recall_at_10": recall, "median_cp_search_ms": cp_ms,
          "plain_cp_search_s": plain_s, "pair_join_max_abs_err": join_err,
          "pair_join_tol": join_tol, "pair_join_reverify_err": reverify_err,
          "distances": res.distances.tolist()})
    emit({"phase": "cp_profile", **profile_call(torch, lambda: index.cp_search(K), cp_ms)})

    pq = build_index(audio, IndexConfig(backend="flat-pq", seed=seed), device=dev)
    counts.reset()
    t0 = time.perf_counter()
    pq_res = pq.cp_search(K)
    pq_s = time.perf_counter() - t0
    pq_used = counts.snapshot()
    check(pq_used["routes"]["pair_join.k_over_128"] == 1,
          f"flat-pq cp_search routes {pq_used['routes']}: expected one k > 128 route")
    pq_recall = len(exact & {tuple(p) for p in pq_res.pairs.tolist()}) / K
    # pairs whose PQ codes are equal: their estimated distance is 0
    _, same = torch.unique(pq.codes, dim=0, return_counts=True)
    emit({"phase": "cp_pq", "R": pq_res.stats.candidates_verified,
          "distinct_code_rows": same.numel(),
          "pairs_with_equal_codes": int((same * (same - 1) // 2).sum()),
          "routes": pq_used["routes"], "launches": pq_used["launches"],
          "recall_at_10": pq_recall, "cp_search_s": pq_s,
          "pairs_estimated": pq_res.stats.point_distance_computations,
          "pairs_verified": pq_res.stats.candidates_verified,
          "tiles_pruned": pq_res.stats.tiles_pruned})
    tile_rows = 2 * 128 * AUDIO_D * 4 * (tiles - tiles_pruned)
    return {"audio": audio, "exact": exact, "index": index,
            "launches": used["launches"]["pair_join"], "err": join_err,
            "fn": lambda: kjoin.pair_join(xs, ks, K, thresh2=thresh2),
            "plain_ms": join_plain_ms, "library": None,
            "bytes": 4 * (AUDIO_N * AUDIO_D + AUDIO_N) + 12 * K,
            "ops": 2 * AUDIO_D * pairs_verified,
            "extra": {"tile_traffic_model_ms": tile_rows / PEAK_BYTES_PER_S * 1e3,
                      "tiles_joined": tiles - tiles_pruned, "bands_joined": bands,
                      "pairs_verified": pairs_verified, "cuda_launches": cuda_launches,
                      "host_syncs": syncs, "launch_device_ms": launch_device_ms,
                      "tile_phase_ms": tile_ns / 1e6, "fold_phase_ms": fold_ns / 1e6,
                      "groups": groups, "tiles_computed": tiles_computed,
                      "extra_tiles": tiles_computed - (tiles - tiles_pruned),
                      "merges": merges}}



def churn_deletes(rng, index, r: int, n_seed: int) -> np.ndarray:
    """Round r's deletes of the stream's churn: 32 rows inserted since the
    build, and in round 0 also 64 seed rows (tombstones in the seed
    segment: it searches at k + 64)."""
    live = index.live_ids()
    kill = rng.choice(live[live >= n_seed], 32, replace=False)
    if r == 0:
        kill = np.concatenate([kill, rng.choice(n_seed, 64, replace=False)])
    return kill


def stream_phase(torch, dev, data, queries, seed: int, *, rounds: int = STREAM_ROUNDS,
                 batch: int = STREAM_BATCH, threshold: int = STREAM_THRESHOLD,
                 checkpoints=STREAM_CHECKPOINTS, flush_after=STREAM_FLUSH_AFTER,
                 batches=BATCHES) -> dict:
    """The streaming index on the card over the Deep1M twin: churn,
    searches at the checkpoints held to a use_kernels=False twin, recall,
    times, a traced split and a profile.  Returns what the kernels line
    needs of the topk kernel."""
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts, ops
    from repro_torch.obs import roofline, trace

    cfg = IndexConfig(backend="streaming", seed=seed, options={
        "segment_backend": "flat", "delta_threshold": threshold, "max_segments": 4})
    t0 = time.perf_counter()
    index = build_index(data, cfg, device=dev)
    twin = build_index(data, cfg.with_options(use_kernels=False), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_seed, d = data.shape
    fresh = make_clustered_twin(rounds * batch, d, seed, rows_seed=seed + 5)
    rng = np.random.default_rng(seed + 6)
    qB = {B: queries[:B] for B in batches}
    churn_s, used, batch_ms, delta_scans = 0.0, None, {}, 0
    for r in range(rounds):
        t0 = time.perf_counter()
        rows = fresh[r * batch:(r + 1) * batch]
        ids = index.insert(rows)
        check(np.array_equal(ids, twin.insert(rows)), f"stream round {r}: insert ids differ")
        kill = churn_deletes(rng, index, r, n_seed)
        check(index.delete(kill) == twin.delete(kill) == kill.size,
              f"stream round {r}: deletes differ")
        if r + 1 in flush_after:
            index.flush()
            twin.flush()
        churn_s += time.perf_counter() - t0
        if r + 1 not in checkpoints:
            continue
        counts.reset()
        answers = {B: index.search(qB[B], K) for B in batches}
        used = counts.snapshot()
        for name in ("pairwise_sq_dist", "radius_select", "verify_topk"):
            check(used["launches"][name] > 0, f"stream path never launched {name}")
        # one topk launch per search for the merge, one more for a non-empty delta
        topk_per_search = 2 if index.delta_size else 1
        check(used["launches"]["topk_smallest"] == topk_per_search * len(batches),
              f"stream path launched topk_smallest {used['launches']['topk_smallest']} "
              f"times, expected {topk_per_search} a search")
        # pairwise: one estimate a sealed segment, one delta scan a non-empty delta
        scans = len(batches) if index.delta_size else 0
        check(used["launches"]["pairwise_sq_dist"]
              == index.segment_count * len(batches) + scans,
              f"stream path launched pairwise_sq_dist {used['launches']['pairwise_sq_dist']} "
              f"times for {index.segment_count} segments and {scans} delta scans")
        delta_scans += scans
        for B in batches:
            check(np.array_equal(answers[B].indices, twin.search(qB[B], K).indices),
                  f"stream after round {r + 1} at B={B}: ids differ from the plain twin's")
        check((index.segment_count, index.delta_size, index.n_flushes, index.n_compactions)
              == (twin.segment_count, twin.delta_size, twin.n_flushes, twin.n_compactions),
              f"stream after round {r + 1}: state differs from the plain twin's")
        live = index.live_ids()
        x = torch.from_numpy(index.get_vectors(live)).to(dev)
        exact = live[exact_knn(torch, x, torch.from_numpy(queries).to(dev), K)]
        del x
        got = answers[max(batches)].indices
        recall = float(np.mean([len(set(got[i]) & set(exact[i])) / K
                                for i in range(len(got))]))
        check(recall > 0.5, f"stream recall@10 {recall} after round {r + 1}")
        for B in batches:
            batch_ms[B] = time_ms(torch, lambda: index.search(qB[B], K), reps=5, warmup=1)
        emit({"phase": "stream", "round": r + 1, "n_live": index.n,
              "segments": index.segment_count,
              "segment_sizes": [s.size for s in index.segments],
              "segment_dead": [s.dead for s in index.segments],
              "delta": index.delta_size, "flushes": index.n_flushes,
              "compactions": index.n_compactions, "launches": used["launches"],
              "routes": used["routes"], "ids_identical_to_plain": True,
              "recall_at_10": recall, "queries_for_recall": len(got),
              "median_batch_ms": {str(B): batch_ms[B] for B in batches},
              "queries_per_s": {str(B): B / batch_ms[B] * 1e3 for B in batches},
              "build_seconds": build_s, "churn_seconds": churn_s})
    check(index.n_flushes >= 3 and index.n_compactions >= 1,
          f"stream: {index.n_flushes} flushes, {index.n_compactions} compactions")
    del twin

    # one traced search at the largest batch: the wall split by span
    B = max(batches)
    with trace.trace() as tr:
        index.search(qB[B], K)
    root, *rest = trace.reference_view(tr)
    spans = []
    for sp in rest:
        row = {"name": sp.name, "parent": sp.parent, "ms": sp.duration_s * 1e3,
               **{k: v for k, v in sp.attrs.items() if k in ("size", "dead", "bytes", "flops")}}
        if sp.name.startswith("kernel."):  # on the card's roofline, as obs_trace holds them
            row["fraction_of_peak"] = roofline.achieved(
                roofline.KernelCost(sp.attrs["bytes"], sp.attrs["flops"]), sp.duration_s,
                roofline.get_peaks("cuda"))["fraction_of_peak"]
            check(row["fraction_of_peak"] <= 1.05,
                  f"stream_trace: {sp.name} at {row['fraction_of_peak']} of the card's ceiling")
        spans.append(row)
    emit({"phase": "stream_trace", "B": B, "root": root.name, "wall_ms": root.duration_s * 1e3,
          "spans": spans})
    profiles(torch, "stream_profile", lambda b: index.search(qB[b], K), batch_ms)

    # the topk kernel at the delta scan's largest shape: a full delta of
    # `threshold` rows, the moment before it is sealed
    q = torch.from_numpy(qB[B]).to(dev)
    x_delta = torch.from_numpy(fresh[:threshold]).to(dev)
    d2 = ops.pairwise_sq_dist(q, x_delta)
    return {"launches": used["launches"]["topk_smallest"], "d2": d2, "q": q,
            "x_delta": x_delta, "delta_scans": delta_scans}


def stream_cp_phase(torch, dev, audio: np.ndarray, exact: set, seed: int,
                    *, batch: int = 8192, threshold: int = 16384) -> None:
    """Closest pair over a streaming index: the Audio twin inserted in
    batches, cp_search held to the use_kernels=False twin's."""
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts
    from repro_torch.obs import trace

    cfg = IndexConfig(backend="streaming", seed=seed, options={
        "segment_backend": "flat", "delta_threshold": threshold})
    empty = np.empty((0, audio.shape[1]), np.float32)
    index = build_index(empty, cfg, device=dev)
    twin = build_index(empty, cfg.with_options(use_kernels=False), device=dev)
    for lo in range(0, audio.shape[0], batch):
        index.insert(audio[lo:lo + batch])
        twin.insert(audio[lo:lo + batch])
    index.cp_search(K)  # warm-up
    counts.reset()
    res = index.cp_search(K)
    used = counts.snapshot()
    check(used["launches"]["pair_join"] > 0, "stream cp path never launched pair_join")
    t0 = time.perf_counter()
    plain = twin.cp_search(K)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(res.pairs, plain.pairs),
          "stream cp: pairs differ from the plain twin's")
    check(res.stats == plain.stats,
          f"stream cp: counters {res.stats} differ from the plain twin's {plain.stats}")
    recall = len(exact & {tuple(p) for p in res.pairs.tolist()}) / K
    check(recall >= 0.5, f"stream cp recall@10 {recall}")
    cp_ms = time_ms(torch, lambda: index.cp_search(K), reps=5, warmup=1)
    with trace.trace() as tr:  # host gather + upload, then the join
        index.cp_search(K)
    split = {sp.name: sp.duration_s * 1e3 for sp in tr.spans}
    emit({"phase": "stream_cp", "n": index.n, "d": index.d, "segments": index.segment_count,
          "delta": index.delta_size, "flushes": index.n_flushes,
          "compactions": index.n_compactions, "launches": used["launches"],
          "routes": used["routes"], "pairs_identical_to_plain": True,
          "counters_identical_to_plain": True, "pairs_verified": res.stats.pairs_verified,
          "tiles_pruned": res.stats.tiles_pruned, "recall_at_10": recall,
          "median_cp_search_ms": cp_ms, "traced_split_ms": split,
          "plain_cp_search_s": plain_s})


def _same_ids(res, want, what: str, d2_tol: float = 0.0) -> None:
    """ids and every WorkStats counter identical, squared distances to
    ``d2_tol``."""
    check(np.array_equal(res.indices, want.indices), f"{what}: ids differ")
    found = res.indices >= 0
    d2 = res.distances[found].astype(np.float64) ** 2
    err = float(np.abs(d2 - want.distances[found].astype(np.float64) ** 2).max(initial=0.0))
    check(err <= d2_tol, f"{what}: squared distances differ by {err} > {d2_tol}")
    check(res.stats.as_dict() == want.stats.as_dict(),
          f"{what}: counters {res.stats} differ from {want.stats}")


def _same_up_to_ties(res, want, what: str, d2_tol: float) -> list:
    """Every WorkStats counter identical, squared distances to ``d2_tol``
    position by position, and ids identical but where the two answers
    rank rows whose squared distances lie within ``d2_tol`` of each
    other: the delta scan's norm-trick d² of a row sits within its
    rounding of a segment row's exact d², and the merge may take either
    first (a stream over sharded segments meets this where the delta
    holds a query's k-th neighbour).  Returns the rows whose ids differ."""
    check(np.array_equal(res.indices >= 0, want.indices >= 0), f"{what}: answers' lengths differ")
    found = res.indices >= 0
    d2 = res.distances[found].astype(np.float64) ** 2
    err = float(np.abs(d2 - want.distances[found].astype(np.float64) ** 2).max(initial=0.0))
    check(err <= d2_tol, f"{what}: squared distances differ by {err} > {d2_tol}")
    check(res.stats.as_dict() == want.stats.as_dict(),
          f"{what}: counters {res.stats} differ from {want.stats}")
    return np.flatnonzero((res.indices != want.indices).any(1)).tolist()


def _contract(res, x: np.ndarray, q: np.ndarray, k: int, what: str) -> None:
    """(B, k) rows, real distances ascending, -1 / +inf only as a tail
    (a bucket baseline may find fewer than k, as the reference's may)."""
    found = res.indices >= 0
    check(res.indices.shape == (q.shape[0], k), f"{what}: answer of shape {res.indices.shape}")
    check(bool((found[:, :-1] >= found[:, 1:]).all())
          and bool(np.isinf(res.distances[~found]).all()), f"{what}: padding inside a row")
    check(all(bool((np.diff(dd[f]) >= 0).all()) for dd, f in zip(res.distances, found)),
          f"{what}: distances not ascending")
    true = np.linalg.norm(x[res.indices[found]] - np.repeat(q, k, 0)[found.ravel()], axis=-1)
    check(np.allclose(res.distances[found], true, rtol=1e-4),
          f"{what}: distances are not the rows' distances to the queries")


def _recall(got: np.ndarray, exact: np.ndarray, k: int) -> float:
    return float(np.mean([len(set(g.tolist()) & set(e.tolist())) / k
                          for g, e in zip(got, exact)]))


def _pair_recall(pairs: np.ndarray, exact: set, k: int) -> float:
    return len(exact & {tuple(sorted(p)) for p in pairs.tolist()}) / k


def pmtree_phase(torch, dev, audio: np.ndarray, exact_pairs: set, seed: int,
                 *, batch: int = PMTREE_BATCH) -> dict:
    """The paper's own index (``pmtree``) on the Audio twin: A and the
    projections on the card, the PM-trees and Algorithms 2 and 4 on the
    host; held to a CPU twin built from the card index's own A and
    projection (ids, pairs and every counter identical); recall."""
    import dataclasses

    from repro_torch.index import IndexConfig, PMTreeBackend, build_index
    from repro_torch.kernels import counts

    t_phase = time.perf_counter()
    cfg = IndexConfig(backend="pmtree", c=1.5, cp_c=4.0, seed=seed,
                      options={"cp_T": PMTREE_CP_T})
    q = make_queries(audio, batch, seed + 7)
    counts.reset()
    t0 = time.perf_counter()
    index = build_index(audio, cfg, device=dev)
    tree = index.impl.tree
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = index.search(q, K)
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp_tree = index.cp_impl.tree
    cp_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp = index.cp_search(K)
    cp_s = time.perf_counter() - t0
    used = counts.snapshot()

    twin = PMTreeBackend.from_arrays(audio, index.a, index.projected, cfg, device="cpu")
    for name, ours, theirs in (("ANN", tree, twin.impl.tree), ("CP", cp_tree, twin.cp_impl.tree)):
        for f in dataclasses.fields(tree):
            check(np.array_equal(getattr(ours, f.name), getattr(theirs, f.name)),
                  f"pmtree: the {name} tree's {f.name} differs from the CPU twin's")
    _same_ids(res, twin.search(q, K), "pmtree search against the CPU twin")
    cp_twin = twin.cp_search(K)
    check(np.array_equal(cp.pairs, cp_twin.pairs)
          and np.array_equal(cp.distances, cp_twin.distances)
          and cp.stats.as_dict() == cp_twin.stats.as_dict(),
          f"pmtree cp_search: {cp.stats} differs from the CPU twin's {cp_twin.stats}")
    _contract(res, audio, q, K, "pmtree search")
    x = torch.from_numpy(audio).to(dev)
    recall = _recall(res.indices, exact_knn(torch, x, torch.from_numpy(q).to(dev), K), K)
    check(recall > 0.5, f"pmtree recall@10 {recall}")
    cp_true = np.linalg.norm(audio[cp.pairs[:, 0]] - audio[cp.pairs[:, 1]], axis=-1)
    check(cp.pairs.shape == (K, 2) and np.allclose(cp.distances, cp_true, rtol=1e-4)
          and bool((np.diff(cp.distances) >= 0).all()),
          "pmtree cp_search: pairs are not k real pairs in ascending distance")
    exact_d = np.sort([np.linalg.norm(audio[i] - audio[j]) for i, j in exact_pairs])
    cp_ratio = float(np.mean(cp.distances / exact_d))
    check(cp_ratio <= cfg.cp_c, f"pmtree cp_search: distance ratio {cp_ratio} > c = {cfg.cp_c}")
    st = res.stats
    emit({"phase": "pmtree", "n": audio.shape[0], "d": audio.shape[1], "m": cfg.m, "B": batch,
          "k": K, "c": cfg.c, "cp_c": cfg.cp_c, "cp_T": PMTREE_CP_T,
          "tree_nodes": tree.n_nodes, "tree_depth": tree.depth,
          "cp_tree_nodes": cp_tree.n_nodes, "cp_tree_depth": cp_tree.depth,
          "launches": used["launches"], "identical_to_cpu_twin": True,
          "build_seconds": build_s, "cp_build_seconds": cp_build_s,
          "ms_per_query": search_s * 1e3 / batch, "cp_search_ms": cp_s * 1e3,
          "rounds": st.rounds, "candidates_verified": st.candidates_verified,
          "node_distance_computations": st.node_distance_computations,
          "point_distance_computations": st.point_distance_computations,
          "recall_at_10": recall, "cp_recall_at_10": _pair_recall(cp.pairs, exact_pairs, K),
          "cp_distance_ratio": cp_ratio, "cp_pairs_verified": cp.stats.pairs_verified,
          "cp_nodes_examined": cp.stats.rounds,
          "seconds": time.perf_counter() - t_phase})
    return {"index": index}


def pmtree_range_phase(torch, dev, index, audio: np.ndarray, seed: int,
                       *, count: int = 64, band: float = 1e-6) -> None:
    """The level-synchronous range mask on the card against the host DFS
    on the Audio twin's ANN tree, at Algorithm 2's first three radii
    (t·r_min, ×c, ×c²): slots equal outside ±``band`` (relative) of the
    radius; CUDA-event ms of the mask beside the DFS's host ms."""
    from repro_torch.core import candidate_budget
    from repro_torch.core.hashing import project_to_host
    from repro_torch.core.pmtree_query import (
        DeviceTree,
        range_mask_device,
        range_query_device,
        range_query_host,
    )

    t_phase = time.perf_counter()
    pm = index.impl
    tree = pm.tree
    qp = project_to_host(pm.family, make_queries(audio, count, seed + 8))
    qd = torch.from_numpy(qp).to(dev)
    dt = DeviceTree.from_host(tree, dev)
    pts64 = tree.points.astype(np.float64)
    max_results = candidate_budget(pm.params, tree.n_points, K)
    r0 = pm.t * pm.rmin(K)
    rows = []
    for radius in (r0, r0 * pm.params.c, r0 * pm.params.c ** 2):
        range_mask_device(dt, qd[0], radius)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        masks = [range_mask_device(dt, qd[j], radius) for j in range(count)]
        end.record()
        end.synchronize()
        mask_ms = start.elapsed_time(end) / count
        t0 = time.perf_counter()
        host = [range_query_host(tree, qp[j], radius)[0] for j in range(count)]
        host_ms = (time.perf_counter() - t0) * 1e3 / count
        in_band = mismatched = hits = 0
        for j in range(count):
            got = masks[j].cpu().numpy()
            want = np.zeros(tree.n_points, bool)
            want[host[j]] = True
            near = np.abs(np.linalg.norm(pts64 - qp[j], axis=-1) - radius) <= band * radius
            in_band += int(near.sum())
            mismatched += int((got[~near] != want[~near]).sum())
            hits += int(want.sum())
        check(mismatched == 0, f"pmtree_range r={radius}: {mismatched} slots differ from the "
                               f"host DFS outside the ±{band} band")
        slots, dist, valid = range_query_device(dt, qd[0], radius, max_results)
        nvalid = int(valid.sum())
        check(nvalid == min(max_results, int(masks[0].sum()))
              and bool(masks[0][slots[valid]].all())
              and bool((dist[valid][1:] >= dist[valid][:-1]).all()),
              f"pmtree_range r={radius}: range_query_device's {nvalid} slots")
        rows.append({"radius": radius, "mean_hits": hits / count, "in_band": in_band,
                     "mismatched_outside_band": mismatched, "mask_ms": mask_ms,
                     "host_dfs_ms": host_ms, "fixed_size_valid": nvalid})
    emit({"phase": "pmtree_range", "queries": count, "nodes": tree.n_nodes,
          "levels": tree.depth, "band": band, "max_results": max_results, "radii": rows,
          "seconds": time.perf_counter() - t_phase})


def baselines_phase(torch, dev, audio: np.ndarray, seed: int, *, batch: int = BASELINE_BATCH,
                    cp_rows: int = BASELINE_CP_ROWS) -> None:
    """The nine §7 baselines built on the card: the ANN ones on the Audio
    twin at B = ``batch``, the CP ones on its first ``cp_rows`` rows.
    Every answer meets the contract and comes within the index's
    approximation ratio c on average (Eq. 12); recall stays above the
    reference's floor (0.2) but where ``RECALL_FLOOR_EXEMPT`` says why
    not; closest pairs keep the distance ratio under the reference's
    2.5."""
    from repro_torch.index import IndexConfig, build_index

    t_phase = time.perf_counter()
    q = make_queries(audio, batch, seed + 9)
    x = torch.from_numpy(audio).to(dev)
    exact = exact_knn(torch, x, torch.from_numpy(q).to(dev), K)
    exact_dist = np.linalg.norm(audio[exact] - q[:, None, :], axis=-1)
    out = {}
    for name, options in ANN_BASELINES:
        cfg = IndexConfig(backend=name, seed=seed, options=options)
        label = name + "".join(f"_{k}{v}" for k, v in options.items())
        t0 = time.perf_counter()
        index = build_index(audio, cfg, device=dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = index.search(q, K)
        query_s = time.perf_counter() - t0
        _contract(res, audio, q, K, label)
        found = res.indices >= 0
        recall = _recall(res.indices, exact, K)
        ratio = float(np.mean((res.distances / exact_dist)[found]))
        check(ratio <= cfg.c, f"{label}: mean distance ratio {ratio} > c = {cfg.c}")
        if (name, options) not in RECALL_FLOOR_EXEMPT:
            check(recall > 0.2, f"{label} recall@10 {recall}")
        out[label] = {"build_seconds": build_s, "query_seconds": query_s,
                      "answers_found": int(found.sum()), "ms_per_query": query_s * 1e3 / batch,
                      "recall_at_10": recall, "distance_ratio": ratio,
                      "candidates_verified": res.stats.candidates_verified}
    sub = audio[:cp_rows]
    exact_pairs = exact_closest_pairs(torch, torch.from_numpy(sub).to(dev), K)
    exact_d = np.sort([np.linalg.norm(sub[i] - sub[j]) for i, j in exact_pairs])
    for name in CP_BASELINES:
        t0 = time.perf_counter()
        index = build_index(sub, IndexConfig(backend=name, seed=seed), device=dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = index.cp_search(K)
        cp_s = time.perf_counter() - t0
        true = np.linalg.norm(sub[res.pairs[:, 0]] - sub[res.pairs[:, 1]], axis=-1)
        check(res.pairs.shape == (K, 2) and bool((res.pairs[:, 0] != res.pairs[:, 1]).all())
              and np.allclose(res.distances, true, rtol=1e-4)
              and bool((np.diff(res.distances) >= 0).all()),
              f"{name} cp_search: not k real pairs in ascending distance")
        ratio = float(np.mean(res.distances / np.maximum(exact_d, 1e-9)))
        check(ratio < 2.5, f"{name} cp_search: distance ratio {ratio}")
        out[f"{name}_cp"] = {"build_seconds": build_s, "cp_search_seconds": cp_s,
                             "cp_recall_at_10": _pair_recall(res.pairs, exact_pairs, K),
                             "distance_ratio": ratio,
                             "pairs_verified": res.stats.pairs_verified}
    emit({"phase": "baselines", "n": audio.shape[0], "d": audio.shape[1], "B": batch, "k": K,
          "median_10nn_distance": float(np.median(exact_dist[:, -1])), "cp_rows": cp_rows,
          "baselines": out, "seconds": time.perf_counter() - t_phase})


def stream_pmtree_phase(torch, dev, audio: np.ndarray, seed: int, *,
                        start: int = STREAM_PM_START, batch: int = STREAM_PM_BATCH,
                        rounds: int = STREAM_PM_ROUNDS, threshold: int = STREAM_PM_THRESHOLD,
                        queries: int = PMTREE_BATCH) -> None:
    """A streaming index over the Audio twin with the default segment
    backend (pmtree): ``start`` seed rows, then ``rounds`` rounds of
    ``batch`` inserts and 32 deletes; after each, a search held to a
    ``use_kernels=False`` twin (ids and counters identical) and recall@10
    over the live rows."""
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts

    t_phase = time.perf_counter()
    cfg = IndexConfig(backend="streaming", seed=seed, options={"delta_threshold": threshold})
    t0 = time.perf_counter()
    index = build_index(audio[:start], cfg, device=dev)
    twin = build_index(audio[:start], cfg.with_options(use_kernels=False), device=dev)
    build_s = time.perf_counter() - t0
    check(index.segment_backend == "pmtree"
          and all(s.backend == "pmtree" for s in index.segments + twin.segments),
          f"stream_pmtree: segments {[s.backend for s in index.segments]}")
    q = make_queries(audio, queries, seed + 10)
    qd = torch.from_numpy(q).to(dev)
    d2_tol = 1e-5 * float((q * q).sum(1).max() + (audio * audio).sum(1).max())
    rng = np.random.default_rng(seed + 11)
    for r in range(rounds):
        t0 = time.perf_counter()
        rows = audio[start + r * batch:start + (r + 1) * batch]
        check(np.array_equal(index.insert(rows), twin.insert(rows)),
              f"stream_pmtree round {r}: insert ids differ")
        kill = rng.choice(index.live_ids(), 32, replace=False)
        check(index.delete(kill) == twin.delete(kill) == 32,
              f"stream_pmtree round {r}: deletes differ")
        churn_s = time.perf_counter() - t0
        counts.reset()
        t0 = time.perf_counter()
        res = index.search(q, K)
        search_s = time.perf_counter() - t0
        used = counts.snapshot()
        merges = 2 if index.delta_size else 1  # the delta's topk, the merge's
        check(used["launches"]["topk_smallest"] == merges
              and used["launches"]["pairwise_sq_dist"] == merges - 1,
              f"stream_pmtree round {r}: launches {used['launches']}")
        # tolerance: the delta scan's norm trick cancels float32
        # |q|² + |x|² (ROADMAP §C), so its d² agree to 1e-5 of that, as the
        # pairwise kernel's are held; the pmtree segments' are bit-identical
        _same_ids(res, twin.search(q, K), f"stream_pmtree round {r + 1} against the plain twin",
                  d2_tol=d2_tol)
        check((index.segment_count, index.delta_size, index.n_flushes, index.n_compactions)
              == (twin.segment_count, twin.delta_size, twin.n_flushes, twin.n_compactions),
              f"stream_pmtree round {r + 1}: state differs from the plain twin's")
        live = index.live_ids()
        xl = torch.from_numpy(index.get_vectors(live)).to(dev)
        recall = _recall(res.indices, live[exact_knn(torch, xl, qd, K)], K)
        del xl
        check(recall > 0.5, f"stream_pmtree recall@10 {recall} after round {r + 1}")
        emit({"phase": "stream_pmtree", "round": r + 1, "n_live": index.n,
              "segments": index.segment_count,
              "segment_sizes": [s.size for s in index.segments],
              "segment_dead": [s.dead for s in index.segments], "delta": index.delta_size,
              "flushes": index.n_flushes, "compactions": index.n_compactions,
              "launches": used["launches"], "ids_identical_to_plain": True,
              "recall_at_10": recall, "B": queries, "ms_per_query": search_s * 1e3 / queries,
              "rounds": res.stats.rounds, "candidates_verified": res.stats.candidates_verified,
              "build_seconds": build_s, "churn_seconds": churn_s,
              "seconds": time.perf_counter() - t_phase})
    check(index.n_flushes >= 2, f"stream_pmtree: {index.n_flushes} flushes")


def _segments_alone(torch, dev, index, q: np.ndarray, options: dict, what: str) -> None:
    """Each sealed segment of ``index`` answers what a standalone index of
    its backend over the segment's rows answers (the index's A where the
    backend takes it), in global ids, bit for bit, counters included."""
    from repro_torch.index import IndexConfig, build_index, get_backend
    from repro_torch.index.backends import ShardedFlatBackend

    for seg in index.segments:
        cls = get_backend(seg.backend)
        cfg = IndexConfig(backend=seg.backend, seed=index.config.seed, options=options)
        rows = index.get_vectors(seg.ids)
        alone = (cls.from_arrays(rows, index._a, None, cfg, device=dev)
                 if issubclass(cls, ShardedFlatBackend) else build_index(rows, cfg, device=dev))
        gids, dd, st = seg.search(q, K)
        ra = alone.search(q, K)
        check(np.array_equal(gids, np.where(ra.indices >= 0, seg.ids[np.maximum(ra.indices, 0)],
                                            -1))
              and np.array_equal(dd.view(np.int32), ra.distances.view(np.int32))
              and st.as_dict() == ra.stats.as_dict(),
              f"{what}: segment {seg.serial} ({seg.size} rows) differs from a standalone "
              f"{seg.backend} index over its rows")
        del alone


def stream_backends_phase(torch, dev, data: np.ndarray, audio: np.ndarray, seed: int) -> None:
    """Streaming indexes whose segments are the reference's other
    backends: sharded-flat and sharded-flat-pq (4 emulated shards a
    segment) churned on the Deep1M twin's first rows, lscan and qalsh on
    the Audio twin.  At each checkpoint each segment's ids equal its
    use_kernels=False twin's, the whole answer's too but at a delta row
    tied with a segment row within the delta scan's rounding, each
    segment answers as a standalone index of its backend over its rows,
    the kernels' launches are read, recall@10 against the exact answers
    is printed."""
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts

    t_phase = time.perf_counter()
    seed_rows = data[:STREAM_BK_SEED]
    n_seed, d = seed_rows.shape
    fresh = make_clustered_twin(STREAM_BK_ROUNDS * STREAM_BATCH, d, seed, rows_seed=seed + 5)
    queries = make_queries(data, max(BATCHES), seed + 30)
    qd = torch.from_numpy(queries).to(dev)
    d2_tol = 1e-5 * float((queries * queries).sum(1).max() + (data * data).sum(1).max())
    for name in STREAM_BK_DEVICE:
        t0 = time.perf_counter()
        opts = {"segment_backend": name, "shards": SHARDS, "delta_threshold": STREAM_BK_THRESHOLD,
                "max_segments": 3}
        cfg = IndexConfig(backend="streaming", seed=seed, options=opts)
        index = build_index(seed_rows, cfg, device=dev)
        twin = build_index(seed_rows, cfg.with_options(use_kernels=False), device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 6)
        for r in range(STREAM_BK_ROUNDS):
            rows = fresh[r * STREAM_BATCH:(r + 1) * STREAM_BATCH]
            check(np.array_equal(index.insert(rows), twin.insert(rows)),
                  f"stream_backends {name} round {r}: insert ids differ")
            kill = churn_deletes(rng, index, r, n_seed)
            check(index.delete(kill) == twin.delete(kill) == kill.size,
                  f"stream_backends {name} round {r}: deletes differ")
            if r + 1 not in STREAM_BK_CHECKPOINTS:
                continue
            check(all(s.backend == name for s in index.segments + twin.segments)
                  and all(s.index.impl.P == SHARDS for s in index.segments),
                  f"stream_backends {name}: segments {[s.backend for s in index.segments]}")
            counts.reset()
            answers = {B: index.search(queries[:B], K) for B in BATCHES}
            used = counts.snapshot()["launches"]
            per_search = SHARDS * index.segment_count
            scans = 1 if index.delta_size else 0
            want = {"verify_topk": per_search * len(BATCHES),
                    "pairwise_sq_dist": (per_search + scans) * len(BATCHES),
                    "topk_smallest": (1 + scans) * len(BATCHES), "radius_select": 0,
                    "adc_dist": per_search * len(BATCHES) if name.endswith("-pq") else 0}
            check({k: used[k] for k in want} == want,
                  f"stream_backends {name} after round {r + 1}: launches {used}, expected "
                  f"{want} (a shard's estimate and verify a segment, ADC for pq; the global "
                  "threshold is a bisection over survivor counts, not radius_select)")
            for sk, sp in zip(index.segments, twin.segments):
                gk, _, _ = sk.search(queries, K + sk.dead)
                check(np.array_equal(gk, sp.search(queries, K + sp.dead)[0]),
                      f"stream_backends {name} after round {r + 1}: segment {sk.serial}'s ids "
                      "differ from the plain twin's")
            at_ties = {str(B): _same_up_to_ties(
                answers[B], twin.search(queries[:B], K),
                f"stream_backends {name} after round {r + 1} at B={B}, against the plain twin",
                d2_tol) for B in BATCHES}
            check((index.segment_count, index.delta_size, index.n_flushes, index.n_compactions)
                  == (twin.segment_count, twin.delta_size, twin.n_flushes, twin.n_compactions),
                  f"stream_backends {name} after round {r + 1}: state differs from the twin's")
            live = index.live_ids()
            xl = torch.from_numpy(index.get_vectors(live)).to(dev)
            recall = _recall(answers[max(BATCHES)].indices, live[exact_knn(torch, xl, qd, K)], K)
            del xl
            check(recall > 0.5, f"stream_backends {name} recall@10 {recall}")
            ms = {str(B): time_ms(torch, lambda: index.search(queries[:B], K), reps=3, warmup=1)
                  for B in BATCHES}
            emit({"phase": "stream_backends", "segment_backend": name, "shards": SHARDS,
                  "round": r + 1, "n_live": index.n, "segments": index.segment_count,
                  "segment_sizes": [s.size for s in index.segments],
                  "segment_dead": [s.dead for s in index.segments], "delta": index.delta_size,
                  "flushes": index.n_flushes, "compactions": index.n_compactions,
                  "launches": {k: v for k, v in used.items() if v},
                  "rows_differing_from_plain_at_ties": at_ties, "recall_at_10": recall,
                  "median_batch_ms": ms, "build_seconds": build_s})
        check(index.n_flushes == 3 and index.n_compactions == 1,
              f"stream_backends {name}: {index.n_flushes} flushes, {index.n_compactions} "
              "compactions")
        _segments_alone(torch, dev, index, queries, {"shards": SHARDS},
                        f"stream_backends {name}")
        emit({"phase": "stream_backends_alone", "segment_backend": name,
              "segments": [s.size for s in index.segments], "identical": True,
              "seconds": time.perf_counter() - t0})
        del index, twin
        gc.collect()
        torch.cuda.empty_cache()

    # the host baselines as segments on the Audio twin
    q = make_queries(audio, BASELINE_BATCH, seed + 31)
    qa = torch.from_numpy(q).to(dev)
    a_tol = 1e-5 * float((q * q).sum(1).max() + (audio * audio).sum(1).max())
    for name in STREAM_BK_HOST:
        t0 = time.perf_counter()
        cfg = IndexConfig(backend="streaming", seed=seed, options={
            "segment_backend": name, "delta_threshold": STREAM_BK_HOST_BATCH})
        index = build_index(audio[:STREAM_BK_HOST_START], cfg, device=dev)
        twin = build_index(audio[:STREAM_BK_HOST_START], cfg.with_options(use_kernels=False),
                           device=dev)
        rng = np.random.default_rng(seed + 32)
        for lo in range(STREAM_BK_HOST_START, len(audio), STREAM_BK_HOST_BATCH):
            rows = audio[lo:lo + STREAM_BK_HOST_BATCH]
            check(np.array_equal(index.insert(rows), twin.insert(rows)),
                  f"stream_backends {name}: insert ids differ")
            kill = rng.choice(index.live_ids(), 32, replace=False)
            check(index.delete(kill) == twin.delete(kill) == 32,
                  f"stream_backends {name}: deletes differ")
            counts.reset()
            t1 = time.perf_counter()
            res = index.search(q, K)
            search_s = time.perf_counter() - t1
            used = counts.snapshot()["launches"]
            scans = 1 if index.delta_size else 0
            check(used["topk_smallest"] == 1 + scans and used["pairwise_sq_dist"] == scans,
                  f"stream_backends {name}: launches {used} (host segments launch nothing)")
            at_ties = _same_up_to_ties(res, twin.search(q, K),
                                       f"stream_backends {name} at {index.n} live rows", a_tol)
        check(all(s.backend == name for s in index.segments) and index.n_flushes >= 2,
              f"stream_backends {name}: segments {[s.backend for s in index.segments]}")
        _segments_alone(torch, dev, index, q, {}, f"stream_backends {name}")
        live = index.live_ids()
        xl = torch.from_numpy(index.get_vectors(live)).to(dev)
        recall = _recall(res.indices, live[exact_knn(torch, xl, qa, K)], K)
        del xl
        emit({"phase": "stream_backends", "segment_backend": name, "n_live": index.n,
              "segments": index.segment_count,
              "segment_sizes": [s.size for s in index.segments], "delta": index.delta_size,
              "flushes": index.n_flushes, "compactions": index.n_compactions,
              "launches": {k: v for k, v in used.items() if v},
              "rows_differing_from_plain_at_ties": at_ties, "segments_identical_to_alone": True, "recall_at_10": recall, "B": len(q),
              "ms_per_query": search_s * 1e3 / len(q), "seconds": time.perf_counter() - t0})
        del index, twin
    emit({"phase": "stream_backends_done", "seconds": time.perf_counter() - t_phase})


def project_phase(torch, dev, x, q, seed: int, m: int = 15) -> dict:
    """ops.project_dist on the Deep1M twin with its own A and B projected
    queries; returns what the kernels line needs."""
    from repro_torch.kernels import counts, ops, ref
    from repro_torch.kernels import project_dist as kproj

    g = torch.Generator(device=dev).manual_seed(seed + 6)
    a = torch.randn((x.shape[1], m), generator=g, device=dev)
    qp = q @ a
    counts.reset()
    got = ops.project_dist(x, a, qp)
    torch.cuda.synchronize()
    used = counts.snapshot()
    check(used["launches"]["project_dist"] == 1, "project path never launched project_dist")
    want = ref.project_dist(x, a, qp)
    scale = (qp * qp).sum(1)[:, None] + ((x @ a) ** 2).sum(1)[None]
    err = float((got - want).abs().max())
    # tolerance: the projection sums in another order than torch.matmul
    worst = float(((got - want).abs() / (1e-5 * scale + 1e-6)).max())
    check(worst <= 1.0, f"project_dist: |diff| up to {worst} of its tolerance")
    del got, want, scale
    B, N, d = q.shape[0], x.shape[0], x.shape[1]
    emit({"phase": "project", "shape": [B, N, d, m], "launches": used["launches"],
          "max_abs_err": err, "err_over_tol": worst})
    return {"launches": used["launches"]["project_dist"], "err": err,
            "fn": lambda: kproj.project_dist(x, a, qp),
            "plain": lambda: ref.project_dist(x, a, qp),
            "library": lambda: torch.cdist(qp, x @ a) ** 2,
            "bytes": 4 * (N * d + d * m + B * m + B * N),
            "ops": 2 * N * d * m + 2 * B * N * m}


def obs_trace_phase(torch, dev, runs: dict, kernels_line: list) -> dict:
    """One warm traced call of each of ``runs`` (name → call): its span
    tree held to EXPECTED_SPAN_TREES, each kernel span placed on the
    card's roofline (its achieved fraction of the attainable ceiling at
    most 1.05: a higher one means the span closed before its kernel
    finished, or a model is wrong) and, where the kernels line timed the
    same kernel at the same shape (KERNEL_LINE_SHAPES), its wall time at
    least 0.9 × that entry's device ms; the Chrome-trace export,
    validated and saved under build/, coverage and the stage summary."""
    from repro_torch.obs import export, roofline, trace

    peaks = roofline.get_peaks("cuda")
    out = {}
    for name, call in runs.items():
        call()  # warm
        torch.cuda.synchronize()
        with trace.trace() as tr:
            call()
        ref = trace.reference_view(tr)  # the port-only spans left out
        tree = [(s.name, s.parent) for s in ref]
        check(tree == EXPECTED_SPAN_TREES[name],
              f"obs_trace {name}: span tree {tree} differs from the expected one")
        chrome = export.to_chrome_trace(tr, peaks=peaks)
        export.validate_chrome_trace(chrome)
        path = os.path.join(ROOT, "build", f"trace_{name}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        export.save_chrome_trace(path, tr, peaks=peaks)
        spans = []
        kernel_spans = [s for s in tr.spans if s.name.startswith("kernel.")]
        for s, want in zip(kernel_spans, KERNEL_LINE_SHAPES[name]):
            cost = roofline.KernelCost(int(s.attrs["bytes"]), int(s.attrs["flops"]))
            placed = roofline.achieved(cost, s.duration_s, peaks)
            line = None
            if want is not None:
                line = next(e for e in kernels_line if e["name"] == want[0]
                            and e.get("shape", want[1]) == want[1])["device_ms"]
            row = {"name": s.name, "wall_ms": s.duration_s * 1e3, "bytes": cost.bytes,
                   "flops": cost.flops, "fraction_of_peak": placed["fraction_of_peak"],
                   "bound": placed["bound"], "kernels_line_device_ms": line,
                   **{k: s.attrs[k] for k in ("rows_read", "passes", "tiles_pruned")
                      if k in s.attrs}}
            spans.append(row)
            check(placed["fraction_of_peak"] <= 1.05,
                  f"obs_trace {name}: {s.name} at {placed['fraction_of_peak']} of the "
                  "card's ceiling")
            check(line is None or row["wall_ms"] >= 0.9 * line,
                  f"obs_trace {name}: {s.name} span {row['wall_ms']} ms under 0.9 × "
                  f"its kernel's {line} device ms")
        summary = export.stage_summary(tr, peaks=peaks)
        emit({"phase": "obs_trace", "path": name, "root_ms": ref[0].duration_s * 1e3,
              "coverage": export.coverage(tr), "kernel_spans": spans,
              "stages": {k: {f: v[f] for f in ("count", "total_us", "fraction_of_peak")
                             if f in v} for k, v in summary["stages"].items()},
              "trace_file": os.path.relpath(path, ROOT)})
        out[name] = spans
    return out


def quality_phase(torch, index, queries: np.ndarray, answers, recall: float) -> None:
    """QualityAuditor on the 1M float index: every one of the B = 64
    answers sampled, audited on the card; the auditor's recall@10 held
    to the recall against the float64 exact answers."""
    from repro_torch.obs import QualityAuditor, get_registry

    auditor = QualityAuditor.for_index(index, sample_fraction=1.0)
    for q, ids, dd in zip(queries, answers.indices, answers.distances):
        auditor.maybe_sample(q, ids, dd)
    sampled, pending = auditor.sampled, auditor.pending
    t0 = time.perf_counter()
    done = auditor.audit()
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    rep = auditor.report()
    check(rep.audited == sampled - rep.pending and done == pending == len(queries),
          f"quality: audited {rep.audited}, sampled {sampled}, pending {rep.pending}")
    check(abs(rep.recall - recall) <= 1.0 / (10 * len(queries)),
          f"quality: auditor recall@10 {rep.recall} vs {recall} against float64")
    reg = get_registry()
    emit({"phase": "quality", "sampled": rep.sampled, "audited": rep.audited,
          "pending": rep.pending, "recall_at_10": rep.recall, "recall_float64": recall,
          "ratio": rep.ratio, "ci_coverage": rep.ci_coverage,
          "nominal_coverage": rep.nominal_coverage, "coverage_pairs": rep.coverage_pairs,
          "calibration_error": rep.calibration_error, "audit_seconds": audit_s,
          "gauges": {n: reg.get(n).get() for n in (
              "quality_recall", "quality_ratio", "quality_ci_coverage",
              "quality_calibration_error")}})


def _quantiles_ms(lat_s: list) -> dict:
    ms = np.asarray(lat_s, np.float64) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean())}


def _accounting(tickets, what: str) -> dict:
    """ok + shed + failed + rejected = submitted, from the responses."""
    statuses = [t.result().status for t in tickets]
    tally = {s: statuses.count(s) for s in ("ok", "shed", "failed", "rejected")}
    check(sum(tally.values()) == len(tickets),
          f"serve {what}: statuses {set(statuses)} do not sum to {len(tickets)} submitted")
    return tally


def _take_counts(total: dict, launches: dict) -> None:
    """Add one pass's launch counts into ``total``."""
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


class _FlushLog:
    """Records each padded batch the scheduler hands ``index.search``
    (a copy of the staging buffer, its k_pad, the answer, the search's
    wall ms), to hold the responses to a direct search of the same
    batch and to the plain path."""

    def __init__(self, index):
        self.index, self.real, self.calls = index, index.search, []

    def __enter__(self):
        def spy(Q, k=None):
            s = time.perf_counter()
            res = self.real(Q, k)
            ms = (time.perf_counter() - s) * 1e3
            self.calls.append((np.array(Q, copy=True), int(k), res, ms))
            return res

        self.index.search = spy
        return self

    def __exit__(self, *exc):
        del self.index.search


def _same_as_direct(log: _FlushLog, answered: list, what: str) -> int:
    """Each flush's batch searched again directly: ids and distances bit
    for bit; each ok response equal to its row of that answer, sliced to
    its k.  ``answered`` holds (query, k, response)."""
    where = {}
    for c, (Q, _, _, _) in enumerate(log.calls):
        for row, q in enumerate(Q):
            where.setdefault(q.tobytes(), []).append((c, row))
    for Q, k_pad, res, _ in log.calls:
        direct = log.real(Q, k_pad)
        check(np.array_equal(direct.indices, res.indices)
              and direct.distances.tobytes() == res.distances.tobytes(),
              f"serve {what}: a direct search of a flushed batch ({Q.shape[0]}, {k_pad}) "
              "answers otherwise")
    checked = 0
    for q, k, r in answered:
        if not r.ok or r.cached:
            continue
        hits = where.get(np.asarray(q, np.float32).tobytes(), [])
        check(len(hits) == 1, f"serve {what}: query found in {len(hits)} flushes")
        c, row = hits[0]
        res = log.calls[c][2]
        check(np.array_equal(r.result.indices, res.indices[row:row + 1, :k])
              and r.result.distances.tobytes() == res.distances[row:row + 1, :k].tobytes(),
              f"serve {what}: a response differs from its flush's row")
        checked += 1
    return checked


def _timed_flush(flush, out: list):
    """``RequestScheduler._flush`` that appends the wall ms of each flush
    that served a request to ``out``."""
    def timed(bkey, reason):
        s = time.perf_counter()
        done = flush(bkey, reason)
        if done:
            out.append((time.perf_counter() - s) * 1e3)
        return done
    return timed


def _same_as_plain(plain, logs: list, what: str) -> dict:
    """The first flush of each (B_pad, k_pad) in ``logs`` searched again
    on the plain path: ids identical, distances within rtol 1e-5 (the
    port's float tolerance).  Returns the shapes with their max abs
    distance error."""
    errs = {}
    for log in logs:
        for Q, k_pad, res, _ in log.calls:
            shape = (Q.shape[0], k_pad)
            if shape in errs:
                continue
            want = plain.search(Q, k_pad)
            check(np.array_equal(want.indices, res.indices),
                  f"serve {what}: a {shape} flush's ids differ from the plain path's")
            found = res.indices >= 0
            got_d, want_d = res.distances[found], want.distances[found]
            check(np.allclose(got_d, want_d, rtol=1e-5, atol=0.0),
                  f"serve {what}: a {shape} flush's distances differ from the plain path's "
                  "beyond rtol 1e-5")
            errs[shape] = float(np.abs(got_d.astype(np.float64) - want_d).max(initial=0.0))
    return errs


def serve_phase(torch, dev, data: np.ndarray, seed: int, *, k: int = SERVE_K,
                clients=SERVE_CLIENTS, closed: int = SERVE_CLOSED, ragged: int = SERVE_RAGGED,
                hot: int = SERVE_HOT, hot_distinct: int = SERVE_HOT_DISTINCT,
                overload: int = SERVE_OVERLOAD, chaos_requests: int = SERVE_CHAOS,
                stream_rows: int = SERVE_STREAM_ROWS, stream_rounds: int = SERVE_STREAM_ROUNDS,
                stream_batch: int = STREAM_BATCH, stream_threshold: int = STREAM_THRESHOLD,
                rerank: int = SERVE_RERANK) -> dict:
    """The serving front end over the Deep1M twin: ``make_retrieval_step``
    (flat) and a degraded tier of the same keys behind sq8 codes, under
    ``RequestScheduler(ServeConfig(b_max=64, k_max=128))``; six passes
    (closed loop beside the naive loop, ragged trace, hot trace with the
    cache on and off, overload, seeded chaos, streaming datastore), each
    printing its line.  Every ok response is held to a direct search of
    its flushed batch (bit for bit), and every flush shape of passes 1-2
    to the plain path; each scheduler pass's launches are read from the
    counts set to 0 just before it."""
    from repro_torch.index import FlatBackend, IndexConfig
    from repro_torch.kernels import counts
    from repro_torch.resilience import chaos
    from repro_torch.serve import RequestScheduler, ServeConfig
    from repro_torch.serve.serve_step import make_retrieval_step

    phase_t0 = time.perf_counter()
    n, d = data.shape
    rng = np.random.default_rng(seed + 40)
    cfg = IndexConfig(backend="flat", seed=seed)
    step, index = make_retrieval_step(data, np.arange(n, dtype=np.int64), k=k,
                                      index_config=cfg, device=dev)
    cheap, _ = make_retrieval_step(data, np.arange(n, dtype=np.int64), k=k,
                                   index_config=cfg.with_options(quant="sq8", rerank=rerank),
                                   device=dev)
    plain = FlatBackend(data, cfg.with_options(use_kernels=False), device=dev, impl=index.impl)
    queries = make_queries(data, 2 * closed + ragged + hot_distinct, seed + 41)
    q_closed, q_ragged = queries[:closed], queries[closed:closed + ragged]
    q_hot = queries[closed + ragged:closed + ragged + hot_distinct]
    q_over = queries[closed:]
    for B in sorted({1, *clients, SERVE_B_MAX}):  # warm each tier's batch shapes
        index.search(queries[:B], k)
        cheap.index.search(queries[:B], k)
    emit({"phase": "serve_setup", "n": n, "d": d, "k": k, "rerank": rerank,
          "card_bytes": (index.impl.data.numel() * 4 + index.impl.projected.numel() * 4
                         + cheap.index.impl.data.numel() * 4
                         + cheap.index.impl.projected.numel() * 4 + cheap.index.codes.numel()),
          "seconds": time.perf_counter() - phase_t0})
    config = ServeConfig(b_max=SERVE_B_MAX, k_max=SERVE_K_MAX, cache=False,
                         default_deadline_ms=1e6, max_queue=4096)

    # -- pass 1: closed loop beside the naive loop; pass 2: ragged trace ----
    # the counts are set to 0 just before each scheduler pass and read
    # just after it, so a pass's launches are its own: neither the naive
    # loop's, nor a warm-up's, nor those of the searches that check it
    counts.reset()
    naive_lat, naive_ids = [], []
    t0 = time.perf_counter()
    for q in q_closed:  # one facade search a request
        s = time.perf_counter()
        _, _, _, res = step(q[None])
        naive_lat.append(time.perf_counter() - s)
        naive_ids.append(res.indices[0])
    naive_wall = time.perf_counter() - t0
    naive_launches = dict(counts.snapshot()["launches"])
    served, closed_lines, round_c64_ms, flush_b64_ms = {}, {}, [], []
    sched_ids, checked, logs = None, 0, []
    for C in clients:
        sched = RequestScheduler(step, config=config)
        [t.result() for t in sched.submit_batch(q_closed[:C], k)]  # warm this B_pad
        if C == SERVE_B_MAX:  # every flush of this pass is a full B_pad = 64 one
            sched._flush = _timed_flush(sched._flush, flush_b64_ms)
        with _FlushLog(index) as log:
            lat, answered, tickets = [], [], []
            counts.reset()
            t0 = time.perf_counter()
            for r in range(closed // C):
                s = time.perf_counter()
                qs = q_closed[r * C:(r + 1) * C]
                batch = sched.submit_batch(qs, k)
                resps = [t.result() for t in batch]
                tickets += batch
                if C == SERVE_B_MAX:
                    round_c64_ms.append((time.perf_counter() - s) * 1e3)
                lat += [x.latency_s for x in resps]
                answered += list(zip(qs, [k] * C, resps))
            wall = time.perf_counter() - t0
            launches = dict(counts.snapshot()["launches"])
        _take_counts(served, launches)
        logs.append(log)
        for name in ("pairwise_sq_dist", "radius_select", "verify_topk"):
            check(launches[name] > 0, f"serve closed loop C={C} never launched {name}")
        tally = _accounting(tickets, f"closed loop C={C}")
        check(all(x.ok for _, _, x in answered), f"serve closed loop C={C}: a request failed")
        checked += _same_as_direct(log, answered, f"closed loop C={C}")
        if C == max(clients):
            sched_ids = np.stack([x.result.indices[0] for _, _, x in answered])
        snap = sched.snapshot()
        closed_lines[str(C)] = {"qps": len(answered) / wall, **_quantiles_ms(lat),
                                "flushes": len(log.calls), "launches": launches,
                                "padding_overhead": snap.padding_overhead,
                                "staging_reuses": snap.staging_reuses, "accounting": tally}
    search_b64_ms = [ms for Q, _, _, ms in logs[-1].calls if Q.shape[0] == SERVE_B_MAX]
    exact = exact_knn(torch, index.impl.data, torch.from_numpy(q_closed).to(dev), k)
    recall_sched = _recall(sched_ids, exact[:len(sched_ids)], k)
    recall_naive = _recall(np.stack(naive_ids[:len(sched_ids)]), exact[:len(sched_ids)], k)
    check(recall_sched == recall_naive,
          f"serve: scheduler recall@{k} {recall_sched} != naive loop's {recall_naive}")
    naive = {"qps": len(q_closed) / naive_wall, **_quantiles_ms(naive_lat),
             "launches": naive_launches}
    median = (lambda xs: float(np.median(xs)) if xs else None)
    emit({"phase": "serve_closed", "k": k, "requests": closed, "naive": naive,
          "clients": closed_lines, "speedup_at_max_c": closed_lines[str(max(clients))]["qps"]
          / naive["qps"], "round_wall_ms_c64": median(round_c64_ms),
          "flush_wall_ms_b64": median(flush_b64_ms), "search_wall_ms_b64": median(search_b64_ms),
          "recall": {"scheduler": recall_sched, "naive": recall_naive}})

    sched = RequestScheduler(step, config=ServeConfig(b_max=SERVE_B_MAX, k_max=SERVE_K_MAX,
                                                      cache=False, max_queue=4096))
    answered, deadlines, burst, i = [], [], True, 0
    with _FlushLog(index) as log:
        counts.reset()
        t0 = time.perf_counter()
        while i < ragged:
            for _ in range(min(64 if burst else 1, ragged - i)):
                kk, dl = int(rng.choice(SERVE_KS)), float(rng.uniform(2.0, 20.0))
                answered.append((q_ragged[i], kk, sched.submit(q_ragged[i], k=kk, deadline_ms=dl)))
                deadlines.append(dl)
                i += 1
            sched.pump()
            if not burst:  # the trickle flushes alone by its deadline
                while not answered[-1][2].done:
                    sched.pump()
            burst = not burst
        sched.drain()
        wall = time.perf_counter() - t0
        ragged_launches = dict(counts.snapshot()["launches"])
    _take_counts(served, ragged_launches)
    logs.append(log)
    for name in ("pairwise_sq_dist", "radius_select", "verify_topk"):
        check(ragged_launches[name] > 0, f"serve ragged trace never launched {name}")
    tally = _accounting([t for _, _, t in answered], "ragged trace")
    answered = [(q, kk, t.result()) for q, kk, t in answered]
    check(tally["ok"] == ragged, f"serve ragged: {tally}")
    checked += _same_as_direct(log, answered, "ragged trace")
    snap = sched.snapshot()
    check(snap.submitted == snap.completed + snap.shed + snap.failed == ragged,
          f"serve ragged: accounting {snap}")
    shapes = sched.compile_shapes
    check(len(shapes) <= len(sched.palette.shapes) == 56,
          f"serve ragged: {len(shapes)} shapes > the palette's {len(sched.palette.shapes)}")
    lat = [r.latency_s for _, _, r in answered]
    emit({"phase": "serve_ragged", "requests": ragged, "ks": list(SERVE_KS),
          "qps": ragged / wall, **_quantiles_ms(lat),
          "deadline_misses": int(sum(r.latency_s * 1e3 > dl
                                     for (_, _, r), dl in zip(answered, deadlines))),
          "flushes": {"full": snap.full_flushes, "deadline": snap.deadline_flushes,
                      "forced": snap.forced_flushes},
          "searches": len(log.calls), "launches": ragged_launches,
          "shapes": len(shapes), "palette": len(sched.palette.shapes),
          "padding_overhead": snap.padding_overhead, "staging_reuses": snap.staging_reuses,
          "compile_misses": snap.compile_misses, "compile_hits": snap.compile_hits,
          "accounting": tally})

    # every flush shape of passes 1-2, once, against the plain path
    plain_errs = _same_as_plain(plain, logs, "passes 1-2")
    check(any(b == SERVE_B_MAX for b, _ in plain_errs), "serve: no flush at B_pad = 64")
    emit({"phase": "serve_kernels", "passes": "closed loop and ragged trace",
          "launches": served, "searches": sum(len(log.calls) for log in logs),
          "responses_held_to_direct_search": checked,
          "plain_twin_shapes": [[b, kp, err] for (b, kp), err in sorted(plain_errs.items())]})

    # -- pass 3: hot trace, the SQ8 cache on and off --------------------------
    w = 1.0 / (1.0 + np.arange(hot_distinct))
    trace_ix = rng.choice(hot_distinct, size=hot, p=w / w.sum())
    hot_lines = {}
    for label, use_cache in (("off", False), ("on", True)):
        sched = RequestScheduler(step, config=ServeConfig(
            b_max=SERVE_B_MAX, k_max=SERVE_K_MAX, cache=use_cache, default_deadline_ms=1e6,
            max_queue=4096))
        warm = [sched.submit(q, k).result() for q in q_hot]  # every hot query seen once
        counts.reset()
        t0 = time.perf_counter()
        resps = [sched.submit(q_hot[j], k).result() for j in trace_ix]
        wall = time.perf_counter() - t0
        used = counts.snapshot()["launches"]
        snap = sched.snapshot()
        if use_cache:
            check(all(r.cached for r in resps), "serve hot: a repeat missed the cache")
            check(not any(used.values()), f"serve hot: a pass of cache hits launched {used}")
            for j, r in zip(trace_ix, resps):
                check(np.array_equal(r.result.indices, warm[j].result.indices),
                      "serve hot: a hit differs from its first answer")
        hot_lines[label] = {"qps": hot / wall, **_quantiles_ms([r.latency_s for r in resps]),
                            "hit_rate": snap.cache_hit_rate, "launches": used}
    emit({"phase": "serve_hot", "requests": hot, "distinct": hot_distinct, **hot_lines,
          "p50_cut": 1.0 - hot_lines["on"]["p50_ms"] / hot_lines["off"]["p50_ms"]})

    # -- pass 4: overload, no pump -------------------------------------------
    sched = RequestScheduler(step, degraded_step=cheap, config=ServeConfig(
        b_max=SERVE_B_MAX, k_max=SERVE_K_MAX, cache=False, default_deadline_ms=1e6,
        max_queue=256, watermark=0.75))
    t0 = time.perf_counter()
    tickets = [sched.submit(q_over[i % len(q_over)], k=int(rng.choice(SERVE_KS)))
               for i in range(overload)]
    peak = sched.queue_depth
    sched.drain()
    wall = time.perf_counter() - t0
    tally = _accounting(tickets, "overload")
    resps = [t.result() for t in tickets]
    snap = sched.snapshot()
    degraded = sum(r.ok and r.degraded for r in resps)
    check(snap.submitted == snap.completed + snap.shed + snap.failed == overload,
          f"serve overload: accounting {snap}")
    check(tally["shed"] > 0 and degraded > 0, f"serve overload: shed {tally['shed']}, "
          f"degraded {degraded}: the bands never engaged")
    emit({"phase": "serve_overload", "submitted": overload, "max_queue": 256,
          "watermark": 0.75, "admitted": tally["ok"] - degraded, "degraded": degraded,
          "shed": tally["shed"], "failed": tally["failed"], "peak_depth": peak,
          "shed_rate": snap.shed_rate, "seconds": wall,
          "degraded_tier_shapes": sorted(s[:2] for s in sched.compile_shapes
                                         if s[2] == "degraded")})

    # -- pass 5: a seeded chaos plan over the serve sites ---------------------
    sched = RequestScheduler(step, degraded_step=cheap, config=ServeConfig(
        b_max=SERVE_B_MAX, k_max=SERVE_K_MAX, cache=False, max_queue=4096))
    # each spec fires with p = 0.2 an access (at most 3 times): at the
    # default 0.05 a pass this short may see no fault at all
    plan = chaos.FaultPlan.seeded(seed, sites=("serve.search", "serve.degraded", "serve.flush"),
                                  prob=0.2)
    tickets = []
    t0 = time.perf_counter()
    try:
        with chaos.active(plan):
            for i in range(chaos_requests):
                tickets.append(sched.submit(q_over[i], k=int(rng.choice(SERVE_KS)),
                                            deadline_ms=20.0))
                while i % 16 == 15 and sched.queue_depth:  # deadline flushes, by the clock
                    sched.pump()
            sched.drain()
    except Exception as e:  # noqa: BLE001 — reported as the check's failure
        check(False, f"serve chaos: {type(e).__name__} escaped the scheduler: {e}")
    tally = _accounting(tickets, "chaos")
    snap = sched.snapshot()
    check(snap.submitted == snap.completed + snap.shed + snap.failed == chaos_requests,
          f"serve chaos: accounting {snap}")
    check(plan.fired(), "serve chaos: the plan fired no fault")
    emit({"phase": "serve_chaos", "requests": chaos_requests, "seed": seed,
          "fired": {f"{s}:{kind}": c for (s, kind), c in sorted(plan.fired().items())},
          "accounting": tally, "retries": snap.retries, "hedges": snap.hedges,
          "quarantine_flushes": snap.quarantine_flushes, "breaker": sched.breaker.state,
          "seconds": time.perf_counter() - t0})

    # -- pass 6: a streaming datastore ----------------------------------------
    t0 = time.perf_counter()
    scfg = IndexConfig(backend="streaming", seed=seed, options={
        "segment_backend": "flat", "delta_threshold": stream_threshold})
    sstep, sindex = make_retrieval_step(data[:stream_rows], np.arange(stream_rows), k=k,
                                        index_config=scfg, device=dev)
    sched = RequestScheduler(sstep, config=ServeConfig(
        b_max=SERVE_B_MAX, k_max=SERVE_K_MAX, default_deadline_ms=1e6, max_queue=4096))
    build_s = time.perf_counter() - t0
    counts.reset()
    evicted, rounds = np.empty(0, np.int64), []
    for r in range(stream_rounds):
        rows = make_clustered_twin(stream_batch, d, seed, rows_seed=seed + 60 + r)
        vals = 5_000_000 + sindex.total_assigned + np.arange(stream_batch)
        probes = rows[:8]
        before = [sched.submit(q, k).result() for q in probes]
        warm = [sched.submit(q, k).result() for q in probes]
        check(all(x.cached for x in warm), f"serve stream round {r}: warm probes missed")
        s = time.perf_counter()
        ids = sched.extend(rows, vals)
        extend_ms = (time.perf_counter() - s) * 1e3
        live = sindex.live_ids()
        victims = rng.choice(live[live < stream_rows], SERVE_STREAM_EVICT, replace=False)
        check(sched.evict(victims) == SERVE_STREAM_EVICT, f"serve stream round {r}: evict")
        evicted = np.concatenate([evicted, victims])
        after = [sched.submit(q, k).result() for q in probes]
        check(not any(x.cached for x in after),
              f"serve stream round {r}: a cache entry from before extend was served")
        pick = rng.choice(stream_batch, SERVE_B_MAX, replace=False)
        s = time.perf_counter()
        resps = [t.result() for t in sched.submit_batch(rows[pick], k)]
        batch_ms = (time.perf_counter() - s) * 1e3
        for j, x in zip(pick, resps):
            check(x.ok and x.result.indices[0, 0] == ids[j] and x.payloads[0, 0] == vals[j],
                  f"serve stream round {r}: inserted key {ids[j]} answered "
                  f"{x.result.indices[0, 0]} / payload {x.payloads[0, 0]}")
        for j, x in enumerate(after):
            check(x.result.indices[0, 0] == ids[j],
                  f"serve stream round {r}: a probe missed its inserted row after extend")
        seen = np.concatenate([x.result.indices[0] for x in resps + after])
        check(not np.isin(seen, evicted).any(), f"serve stream round {r}: an evicted id answered")
        rounds.append({"extend_ms": extend_ms, "batch_ms": batch_ms,
                       "segments": sindex.segment_count, "delta": sindex.delta_size,
                       "stale_before": int(sum(x.cached for x in before))})
    used = counts.snapshot()
    check(used["launches"]["topk_smallest"] > 0, "serve stream pass never launched topk_smallest")
    snap = sched.snapshot()
    emit({"phase": "serve_stream", "seed_rows": stream_rows, "rounds": rounds,
          "inserted": stream_rounds * stream_batch, "evicted": int(evicted.size),
          "launches": used["launches"], "cache_invalidations": sched.cache.generation,
          "cache_hit_rate": snap.cache_hit_rate, "build_seconds": build_s,
          "flushes": sindex.n_flushes, "compactions": sindex.n_compactions})
    emit({"phase": "serve", "seconds": time.perf_counter() - phase_t0,
          "launches_passes_1_2": served, "launches_stream": used["launches"]})
    return {"launches": served, "stream_launches": used["launches"]}


def _twin_with_force(index, force: str):
    """The same sharded index (shared device blocks) run through the
    kernels' plain versions."""
    import copy

    twin = copy.copy(index)
    twin.impl = copy.copy(index.impl)
    twin.impl.force = force
    return twin


def _budget_edge(torch, flat_impl, q: np.ndarray, T: int):
    """Per query row, from the flat index's own estimate: whether its T-th
    and (T+1)-th smallest projected distances tie (the exact candidate
    set's only exception), and how many rows lie at or under its T-th
    smallest (the exact threshold's survivors: T plus the ties)."""
    from repro_torch.kernels import ops

    qt = torch.from_numpy(q).to(flat_impl.data.device)
    d2p = ops.pairwise_sq_dist(flat_impl.family.project(qt), flat_impl.projected)
    edge = torch.sort(d2p, dim=1).values[:, T - 1:T + 1]
    survivors = (d2p <= edge[:, :1]).sum(1)
    return (edge[:, 0] == edge[:, 1]).cpu().numpy(), survivors.cpu().numpy()


def _legacy_pad_probe(torch, dev) -> dict:
    """The legacy layout pads the last shard with +inf rows, whose norm-
    trick estimate is inf − inf, a NaN: the same small index (n = 203 ∤
    4, A and projection from numpy) on the card and on the CPU, its pad
    estimate's bits and its negation's on each, and the rows of 256
    queries (k = 10, T = 20) whose answers differ.  A positive negated
    NaN ranks first in a shard's local top-T′ (``lax.top_k``'s total
    order, which the port keeps) and displaces a real row; a negative
    one ranks last."""
    from repro_torch.core.distributed import DistributedFlatIndex, _norm_trick
    from repro_torch.launch import make_data_mesh

    rng = np.random.default_rng(11)
    centers = rng.normal(size=(20, 24)) * 4.0
    x = (centers[rng.integers(0, 20, 203)] + rng.normal(size=(203, 24)) * 0.5).astype(np.float32)
    a = np.random.default_rng(0).normal(size=(24, 15)).astype(np.float32)
    rng = np.random.default_rng(5)
    q = (x[rng.integers(0, 203, 256)] + rng.normal(size=(256, 24)) * 0.5).astype(np.float32)
    out = {"phase": "sharded_legacy_pad", "n": 203, "P": 4, "k": K, "T": 20}
    ids = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        index = DistributedFlatIndex(x, make_data_mesh(4, device=where), a=a, projected=x @ a)
        qp = index.family.project(torch.from_numpy(q[:1]).to(where))
        pad = _norm_trick(qp, index._lay.blocks[-1][1])[0, -1]
        out[f"pad_estimate_bits_{name}"] = hex(pad.view(torch.int32).item() & 0xFFFFFFFF)
        # what the local top-T′ ranks: the negated estimate's bits
        out[f"negated_bits_{name}"] = hex((-pad).view(torch.int32).item() & 0xFFFFFFFF)
        ids[name] = index.query(q, K, T=20)[0]
    out["rows_differing"] = np.flatnonzero((ids["card"] != ids["cpu"]).any(1)).tolist()
    return out


def sharded_phase(torch, dev, data: np.ndarray, queries: np.ndarray, exact: np.ndarray,
                  flat, flat_recall: float, pq_recall: float, audio: np.ndarray,
                  seed: int, *, shards: int = SHARDS) -> None:
    """The sharded backends on the card: ``sharded-flat`` over an emulated
    P-shard mesh on the Deep1M twin against ``flat`` (ids and distances
    bit for bit at B = 1, 16, 64, a shard's launches, its plain twin),
    over a world-size-1 NCCL group against the emulated P = 1 mesh,
    ``sharded-flat-pq`` (recall against flat-pq's, adc launches, plain
    twin), ``cp_search`` on the Audio twin against flat's, and the
    legacy ``sharded`` backend's recall.  Each step prints its line."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import candidate_budget
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts
    from repro_torch.launch import make_data_mesh

    phase_t0 = time.perf_counter()
    n = data.shape[0]
    T = candidate_budget(flat.impl.params, n, K)
    cfg = IndexConfig(backend="sharded-flat", seed=seed, options={"shards": shards})
    t0 = time.perf_counter()
    sh = build_index(data, cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plain = _twin_with_force(sh, "plain")
    line = {"phase": "sharded", "backend": "sharded-flat", "P": shards, "n": n,
            "nl": sh.impl.nl, "T": T, "build_seconds": build_s, "batches": {}}
    for B in BATCHES:
        qB = queries[:B]
        counts.reset()
        res = sh.search(qB, K)
        used = counts.snapshot()
        want = flat.search(qB, K)
        rows = np.flatnonzero((res.indices != want.indices).any(1)
                              | (res.distances.view(np.int32)
                                 != want.distances.view(np.int32)).any(1))
        tied, survivors = _budget_edge(torch, flat.impl, qB, T)
        check(tied[rows].all(), f"sharded-flat at B={B}: rows {rows.tolist()} differ from "
                                f"flat's with no tie at the T-th projected distance")
        launches = {k: used["launches"][k] for k in ("pairwise_sq_dist", "verify_topk",
                                                     "radius_select", "topk_smallest")}
        check(launches["pairwise_sq_dist"] == shards and launches["verify_topk"] == shards
              and launches["radius_select"] == 0,
              f"sharded-flat at B={B}: launches {launches}, expected {shards} pairwise and "
              f"verify, no radius_select")
        # the exact threshold keeps T a row plus the rows tied at its T-th
        # distance, counted here from flat's own estimate; the fused flat
        # path counts its ladder's survivors (printed beside)
        check(res.stats.candidates_selected == int(survivors.sum()),
              f"sharded-flat at B={B}: candidates_selected {res.stats.candidates_selected} "
              f"!= {int(survivors.sum())} rows at or under each T-th projected distance")
        counts.reset()
        res_plain = plain.search(qB, K)
        check(not any(counts.LAUNCHES.values()), "the plain twin launched a kernel")
        check(np.array_equal(res_plain.indices, res.indices),
              f"sharded-flat at B={B}: kernel ids differ from the plain twin's")
        ms = time_ms(torch, lambda: sh.search(qB, K), reps=5, warmup=1)
        flat_ms = time_ms(torch, lambda: flat.search(qB, K), reps=5, warmup=1)
        line["batches"][str(B)] = {
            "ids_identical_to_flat": not rows.size, "rows_differing": rows.tolist(),
            "rows_tied_at_T": np.flatnonzero(tied).tolist(),
            "candidates_selected": res.stats.candidates_selected, "B_times_T": B * T,
            "flat_fused_candidates_selected": want.stats.candidates_selected,
            "max_shard_candidates": res.stats.max_shard_candidates, "launches": launches,
            "plain_ids_identical": True, "median_batch_ms": ms, "flat_median_batch_ms": flat_ms}
    emit(line)
    profiles(torch, "sharded_profile", lambda B: sh.search(queries[:B], K),
             {B: line["batches"][str(B)]["median_batch_ms"] for B in BATCHES})

    # a world-size-1 NCCL process group against the emulated P = 1 mesh
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        mesh = make_data_mesh(device="cuda")
        grp = build_index(data, IndexConfig(backend="sharded-flat", seed=seed,
                                            options={"mesh": mesh}), device=dev)
        r_grp = grp.search(queries, K)
        grp_ms = time_ms(torch, lambda: grp.search(queries, K), reps=5, warmup=1)
        del grp
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    one = build_index(data, IndexConfig(backend="sharded-flat", seed=seed,
                                        options={"shards": 1}), device=dev)
    r_one = one.search(queries, K)
    del one
    check(np.array_equal(r_grp.indices, r_one.indices)
          and np.array_equal(r_grp.distances.view(np.int32), r_one.distances.view(np.int32))
          and r_grp.stats.as_dict() == r_one.stats.as_dict(),
          "sharded-flat: the NCCL group of one differs from the emulated P = 1 mesh")
    emit({"phase": "sharded_group", "backend": "nccl", "world_size": 1, "B": len(queries),
          "identical_to_emulated": True, "median_batch_ms": grp_ms,
          "seconds": time.perf_counter() - t0})

    # sharded-flat-pq: per-shard codebooks, the ADC rerank on each shard
    t0 = time.perf_counter()
    pq = build_index(data, IndexConfig(backend="sharded-flat-pq", seed=seed,
                                       options={"shards": shards}), device=dev)
    torch.cuda.synchronize()
    pq_build_s = time.perf_counter() - t0
    counts.reset()
    r_pq = pq.search(queries, K)
    pq_used = counts.snapshot()["launches"]
    check(pq_used["adc_dist"] == shards and pq_used["verify_topk"] == shards,
          f"sharded-flat-pq: launches {pq_used}, expected {shards} adc and verify")
    recall = float(np.mean([len(set(r_pq.indices[i]) & set(exact[i])) / K
                            for i in range(len(queries))]))
    check(recall >= 0.95 * pq_recall,
          f"sharded-flat-pq recall@10 {recall} < 0.95 × flat-pq's {pq_recall}")
    r_pq_plain = _twin_with_force(pq, "plain").search(queries, K)
    check(np.array_equal(r_pq_plain.indices, r_pq.indices),
          "sharded-flat-pq: kernel ids differ from the plain twin's")
    pq_ms = time_ms(torch, lambda: pq.search(queries, K), reps=5, warmup=1)
    emit({"phase": "sharded_pq", "P": shards, "B": len(queries), "build_seconds": pq_build_s,
          "launches": {k: v for k, v in pq_used.items() if v}, "recall_at_10": recall,
          "flat_pq_recall_at_10": pq_recall, "plain_ids_identical": True,
          "R": r_pq.stats.candidates_verified, "median_batch_ms": pq_ms,
          "bytes_per_point": pq.bytes_per_point()})
    del pq

    # closest pairs on the Audio twin: the ring of dense block joins
    flat_a = build_index(audio, IndexConfig(backend="flat", seed=seed), device=dev)
    cf = flat_a.cp_search(K)
    del flat_a
    sa = build_index(audio, IndexConfig(backend="sharded-flat", seed=seed,
                                        options={"shards": shards}), device=dev)
    sa.cp_search(K)  # lays the key-sorted blocks out once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts.reset()
    t0 = time.perf_counter()
    cs = sa.cp_search(K)
    cp_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(np.array_equal(cs.pairs, cf.pairs)
          and np.array_equal(cs.distances.view(np.int32), cf.distances.view(np.int32)),
          f"sharded-flat cp_search: {cs.pairs.tolist()} differ from flat's {cf.pairs.tolist()}")
    emit({"phase": "sharded_cp", "P": shards, "n": len(audio), "d": audio.shape[1], "k": K,
          "cp_nl": sa.impl._cp["nl"], "tile": sa.impl._cp["tile"],
          "pairs_identical_to_flat": True, "distances_identical_to_flat": True,
          "pairs_verified": cs.stats.pairs_verified, "tiles_pruned": cs.stats.tiles_pruned,
          "max_shard_pairs": cs.stats.max_shard_pairs,
          "flat_pairs_verified": cf.stats.pairs_verified,
          "launches": {k: v for k, v in counts.LAUNCHES.items() if v},
          "wall_s": cp_s, "peak_bytes": peak, "peak_bytes_above_index": peak - base})
    del sa

    # the legacy backend: local top-T′ and a tournament merge
    lg = build_index(data, IndexConfig(backend="sharded", seed=seed,
                                       options={"devices": shards}), device=dev)
    counts.reset()
    r_lg = lg.search(queries, K)
    check(not any(counts.LAUNCHES.values()), "the legacy sharded backend launched a kernel")
    lg_recall = float(np.mean([len(set(r_lg.indices[i]) & set(exact[i])) / K
                               for i in range(len(queries))]))
    check(lg_recall >= 0.9 * flat_recall,
          f"legacy sharded recall@10 {lg_recall} < 0.9 × flat's {flat_recall}")
    lg_ms = time_ms(torch, lambda: lg.search(queries, K), reps=3, warmup=1)
    local_T = lg.impl.local_budget(T, K)
    del lg
    emit({"phase": "sharded_legacy", "P": shards, "B": len(queries), "local_T": local_T,
          "recall_at_10": lg_recall, "flat_recall_at_10": flat_recall,
          "median_batch_ms": lg_ms})
    emit({**_legacy_pad_probe(torch, dev), "phase_seconds": time.perf_counter() - phase_t0})
    torch.cuda.empty_cache()


def durable_phase(torch, dev, data: np.ndarray, queries: np.ndarray, seed: int, *,
                  rounds: int = DURABLE_ROUNDS, batch: int = STREAM_BATCH,
                  threshold: int = STREAM_THRESHOLD, flush_after: int = DURABLE_FLUSH_AFTER,
                  crash_round: int = DURABLE_CRASH_ROUND) -> None:
    """A durable streaming index over the Deep1M twin (WAL with fsync,
    snapshots every 8 records at a flush), two injected crashes, each
    index abandoned without close() and recovered on the card, held to a
    twin fed the same ops without durability: ids identical, distances
    bit for bit at B = 64, the same n, segments, flushes, compactions."""
    import shutil

    from repro_torch.index import IndexConfig, build_index
    from repro_torch.obs import get_registry
    from repro_torch.obs.metrics import Histogram
    from repro_torch.resilience import FaultPlan, FaultSpec, chaos, recover

    phase_t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "durable")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    emit({"phase": "durable_disk", "free_bytes": disk.free, "total_bytes": disk.total})
    reg = get_registry()
    series = ("wal_records_total", "wal_fsync_seconds", "recovery_replayed_total",
              "snapshot_commits_total")
    before = reg.snapshot()
    base = IndexConfig(backend="streaming", seed=seed, options={
        "segment_backend": "flat", "delta_threshold": threshold})
    cfg = base.with_options(durability={"dir": root, "sync": True, "snapshot_every": 8})
    issued = {"insert": 0, "delete": 0, "flush": 0, "compact": 0}
    # every WAL fsync's seconds, the seed record's included, beside the
    # histogram's buckets: each WAL the phase opens binds the class's
    # observe, so the hook sees all the observations the metric counts
    fsyncs: list = []
    observe = Histogram.observe

    def observe_fsync(hist, value, exemplar=None, **labels):
        if hist.name == "wal_fsync_seconds":
            fsyncs.append(float(value))
        observe(hist, value, exemplar, **labels)

    Histogram.observe = observe_fsync
    try:
        t0 = time.perf_counter()
        index = build_index(data, cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        issued["insert"] += 1
        issued["flush"] += index.n_flushes
        wal_bytes = [os.path.getsize(os.path.join(root, "wal.log"))]
        twin = build_index(data, base, device=dev)
        n_seed, d = data.shape
        fresh = make_clustered_twin(rounds * batch, d, seed, rows_seed=seed + 7)
        rng = np.random.default_rng(seed + 8)
        insert_ms, twin_ms, snapshots = [], [], []

        def insert(index, rows):
            t = time.perf_counter()
            ids = index.insert(rows)
            insert_ms.append((time.perf_counter() - t) * 1e3)
            issued["insert"] += 1
            t = time.perf_counter()
            check(np.array_equal(ids, twin.insert(rows)), "durable: insert ids differ")
            twin_ms.append((time.perf_counter() - t) * 1e3)

        def delete(index, r):
            kill = churn_deletes(rng, twin, r, n_seed)
            check(index.delete(kill) == twin.delete(kill) == kill.size, "durable: deletes differ")
            issued["delete"] += 1

        def snapshot(index):
            t = time.perf_counter()
            path = index.snapshot()
            size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            snapshots.append({"seconds": time.perf_counter() - t, "bytes": size,
                              "name": os.path.basename(path)})

        def held(recovered, report, what):
            state = lambda ix: (ix.n, ix.segment_count, ix.n_flushes, ix.n_compactions)
            check(state(recovered) == state(twin),
                  f"durable {what}: state {state(recovered)} vs the twin's {state(twin)}")
            a, b = recovered.search(queries, K), twin.search(queries, K)
            check(np.array_equal(a.indices, b.indices), f"durable {what}: ids differ")
            check(np.array_equal(a.distances.view(np.int32), b.distances.view(np.int32)),
                  f"durable {what}: distances differ bit for bit")
            emit({"phase": "durable_recover", "crash": what, "n": recovered.n,
                  "segments": recovered.segment_count, "flushes": recovered.n_flushes,
                  "compactions": recovered.n_compactions,
                  "snapshot_lsn": report.snapshot_lsn, "records_replayed": report.records_replayed,
                  "records_skipped": report.records_skipped,
                  "torn_bytes_truncated": report.torn_bytes_truncated,
                  "bytes_verified": report.bytes_verified, "wall_seconds": report.wall_seconds,
                  "ids_identical": True, "distances_bit_identical": True})

        # (a) rounds 1..crash_round − 1, a flush (it snapshots: ≥ 8 records),
        # then an error at stream.apply in the crash round's insert: the op
        # reached the WAL, so the recovered index holds it
        for r in range(crash_round - 1):
            insert(index, fresh[r * batch:(r + 1) * batch])
            delete(index, r)
            wal_bytes.append(os.path.getsize(os.path.join(root, "wal.log")))
            if r + 1 == flush_after:
                t = time.perf_counter()
                index.flush()  # seals the delta, then snapshots (≥ 8 records)
                flush_snapshot_s = time.perf_counter() - t
                twin.flush()
                issued["flush"] += 1
                check(index.durability.records_since_snapshot == 0,
                      "durable: the flush did not snapshot")
                path = sorted(p for p in os.listdir(root) if p.startswith("snap_"))[-1]
                snapshots.append({"seconds_with_flush": flush_snapshot_s, "name": path,
                                  "bytes": sum(os.path.getsize(os.path.join(root, path, f))
                                               for f in os.listdir(os.path.join(root, path)))})
        rows = fresh[(crash_round - 1) * batch:crash_round * batch]
        with chaos.active(FaultPlan([FaultSpec("stream.apply", "error", at=0)])):
            try:
                index.insert(rows)
                check(False, "durable: the injected error at stream.apply never fired")
            except chaos.ChaosError:
                pass
        issued["insert"] += 1
        twin.insert(rows)
        del index  # abandoned: no close()
        recovered, report = recover(root, device=dev)
        held(recovered, report, "stream.apply")

        # (b) the crash round's deletes and a committed snapshot, one more
        # round (the WAL tail), then an error at snapshot.commit
        delete(recovered, crash_round - 1)
        snapshot(recovered)
        for r in range(crash_round, rounds):
            insert(recovered, fresh[r * batch:(r + 1) * batch])
            delete(recovered, r)
        with chaos.active(FaultPlan([FaultSpec("snapshot.commit", "error", at=0)])):
            try:
                recovered.snapshot()
                check(False, "durable: the injected error at snapshot.commit never fired")
            except chaos.ChaosError:
                pass
        del recovered
        again, report = recover(root, device=dev)
        check(report.snapshot_lsn is not None and report.records_replayed == 2 * (rounds - crash_round),
              f"durable snapshot.commit: {report} did not use the older snapshot and the tail")
        held(again, report, "snapshot.commit")
        again.close()
    finally:
        Histogram.observe = observe
    delta = reg.delta(reg.snapshot(), before)
    check(len(fsyncs) == delta["wal_fsync_seconds"]["series"][""]["count"],
          f"durable: {len(fsyncs)} fsyncs seen, the histogram counts "
          f"{delta['wal_fsync_seconds']['series']['']['count']}")
    records = {k.split("=", 1)[1]: v for k, v in delta["wal_records_total"]["series"].items()}
    check(all(records.get(op, 0.0) == n for op, n in issued.items()),
          f"durable: wal_records_total {records} vs the ops issued {issued}")
    prom = [line for line in reg.to_prometheus().splitlines()
            if line.startswith(series)]
    snap_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(root) for f in fs)
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "durable", "seconds": time.perf_counter() - phase_t0,
          "n_seed": n_seed, "d": d, "rounds": rounds, "batch": batch,
          "build_seconds": build_s, "wal_bytes_max": max(wal_bytes),
          "wal_bytes_after_seed": wal_bytes[0], "dir_bytes_at_end": snap_bytes,
          "fsyncs": len(fsyncs), "fsync_p50_s": statistics.median(fsyncs),
          "fsync_seed_s": fsyncs[0],
          "insert_ms_sync_median": statistics.median(insert_ms),
          "insert_ms_twin_median": statistics.median(twin_ms),
          "snapshots": snapshots, "ops_issued": issued, "prometheus": prom})


def _rel_err(torch, got, want) -> float:
    return float(torch.linalg.norm((got - want).float()) / torch.linalg.norm(want.float()))


def _corr(torch, a, b) -> float:
    return float(torch.corrcoef(torch.stack([a.flatten().float(), b.flatten().float()]))[0, 1])


def lm_serve_phase(torch, dev, seed: int) -> dict:
    """yi-6b at its full configuration in bfloat16 on seeded parameters:
    ``serve_batch`` (4 prompts of 4,096 tokens, 32 greedy tokens), the
    same prefill and decode steps timed by CUDA events, checks (a)–(d)
    and the bounds.  Returns what ``lm_knn`` needs."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import layers as L
    from repro_torch.models import lsh_attention as lsh
    from repro_torch.models import transformer as tt
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    H, KV, hd, m, Vp, d = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.lsh_m,
                           cfg.padded_vocab(), cfg.d_model)
    check((cfg.n_layers, d, H, KV, hd, cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 4, 128, 11008,
                                                                      64000)
          and cfg.dtype == torch.bfloat16 and cfg.lsh_attention and cfg.lsh_topk == 2048
          and m == 16, f"lm_serve: {cfg.name} is not yi-6b's full configuration")
    max_seq = P + G
    mesh = make_host_mesh(device=dev)
    base = held_bytes(torch)  # before the parameters (the dry run's cells)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tt.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    # param_count counts the matrices and both embeddings; the model adds
    # each layer's two norms and lsh_a, and the final norm
    extra = cfg.n_layers * (2 * d + hd * m) + d
    check(n_params == cfg.param_count() + extra,
          f"lm_serve: {n_params} parameters, not yi-6b's {cfg.param_count()} + {extra}")

    # -- serve_batch, then the same steps under CUDA events ------------------
    out = serve_batch(cfg, mesh, batch=B, prompt_len=P, gen=G, seed=seed, params=params)
    logits, tokens = out["logits"], out["tokens"]
    check(tuple(logits.shape) == (B, G, Vp) and bool(torch.isfinite(logits).all()),
          f"lm_serve (a): logits {tuple(logits.shape)} not all finite")
    check(tokens.shape == (B, G) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size,
          f"lm_serve (a): tokens outside [0, {cfg.vocab_size})")
    prefill, _ = make_prefill(cfg, mesh, batch=B, seq_len=P, max_seq=max_seq)
    decode, _ = make_decode_step(cfg, mesh, batch=B, max_seq=max_seq)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    prompt_t = torch.from_numpy(prompts).to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 2)]
    ev[0].record()
    lg, caches = prefill(params, {"tokens": prompt_t})
    ev[1].record()
    tok = torch.argmax(lg, dim=-1).to(torch.int32)
    timed = []
    for i in range(G):  # each step: the argmax before it and the decode
        timed.append(tok[:, 0])
        lg, caches = decode(params, caches, {"tokens": tok, "position": P + i})
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        ev[i + 2].record()
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G)]
    repeat_same = bool(np.array_equal(torch.stack(timed, 1).cpu().numpy(), tokens))
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    peak_serve = torch.cuda.max_memory_allocated()
    decode_med = statistics.median(decode_ms)
    # where the time goes: one decode step (the last position again) and
    # one prefill, by CUDA kernel, beside their untraced times
    last = {"tokens": tok, "position": P + G - 1}
    decode_profile = profile_call(torch, lambda: decode(params, caches, last), decode_med, rows=8,
                                  pause=LM_PROFILE_PAUSE_S, traces=LM_PROFILE_TRACES)
    del caches, lg, timed
    prefill_profile = profile_call(torch, lambda: prefill(params, {"tokens": prompt_t}),
                                   prefill_ms, rows=8)

    # -- the bounds, from this run's shapes ------------------------------------
    mats = sum(p.numel() for n, p in params.blocks.named_parameters()
               if p.ndim == 2 and not n.endswith("lsh_a"))
    T = min(cfg.lsh_topk, max_seq)
    weight_bytes = param_bytes - Vp * d * 2 + B * d * 2  # the embedding: B rows a token
    kv_gathered = cfg.n_layers * B * KV * T * hd * 2 * 2  # k and v, bf16
    pk_read = cfg.n_layers * B * max_seq * KV * m * 2
    decode_bound_ms = (weight_bytes + kv_gathered + pk_read) / PEAK_BYTES_PER_S * 1e3
    mm_flop = 2 * B * P * mats + 2 * B * d * Vp  # the head on the last position only
    sk_pad = -(-max_seq // 1024) * 1024  # chunked attention pads k/v to whole chunks
    attn_flop = cfg.n_layers * 4 * B * H * P * sk_pad * hd  # QKᵀ and PV, float32
    prefill_bytes = param_bytes + cache_bytes
    prefill_bounds_ms = {"bf16_matmul": mm_flop / PEAK_BF16_PER_S * 1e3,
                         "f32_attention": attn_flop / PEAK_F32_PER_S * 1e3,
                         "bytes": prefill_bytes / PEAK_BYTES_PER_S * 1e3}

    # -- (b) decode after prefill = the full forward's last logits -------------
    with torch.inference_mode():
        full, _ = tt.forward(params, prompt_t, cfg, logits_slice="last")  # the flash route
        caches = tt.init_cache(cfg, B, P, device=dev)
        tt.forward(params, prompt_t[:, :P - 1], cfg, caches=caches, logits_slice="last")
        dense = cfg.replace(lsh_topk=P)  # T ≥ kv_len: every key a candidate
        dec, _ = tt.decode_step(params, caches, {"tokens": prompt_t[:, P - 1:],
                                                 "position": P - 1}, dense)
    rel_b, corr_b = _rel_err(torch, dec, full), _corr(torch, dec, full)
    argmax_b = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    check(rel_b <= LM_CONSISTENCY_REL and corr_b >= LM_CONSISTENCY_CORR,
          f"lm_serve (b): decode vs forward relative error {rel_b}, corr {corr_b}")
    del full, dec

    # -- (c) layer 0's prefilled cache: LSH at T = kv_len against dense --------
    with torch.inference_mode():
        blk, c0 = params.blocks[0], caches[0]
        x = L.rms_norm(params.embed[prompt_t[:, P - 1:]].to(cfg.dtype), blk["ln1"],
                       cfg.norm_eps)
        q = L.rope((x @ blk["attn"]["wq"]).reshape(B, 1, H, hd),
                   torch.tensor([P - 1], device=dev), cfg.rope_theta)
        a = blk["attn"]["lsh_a"]
        c_err = {}
        dense32 = lsh.lsh_attention_reference(q.float(), c0["k"], c0["v"], kv_len=P)
        for name, qq, tol in (("bf16", q, LM_LSH_BF16_TOL), ("f32", q.float(), LM_LSH_F32_TOL)):
            got = lsh.lsh_decode_attention(qq, c0["k"], c0["v"], c0["pk"], a, kv_len=P, topk=P)
            want = lsh.lsh_attention_reference(qq, c0["k"], c0["v"], kv_len=P)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            c_err[name] = {"max_abs_err": err, "max_abs": scale, "tol": tol * scale}
            check(err <= tol * scale, f"lm_serve (c): {name} LSH at T = kv_len differs from "
                                      f"dense by {err} > {tol * scale}")
        # T = 2048: the approximation, printed
        T_lsh = cfg.lsh_topk
        approx = lsh.lsh_decode_attention(q.float(), c0["k"], c0["v"], c0["pk"], a, kv_len=P,
                                          topk=T_lsh)
        rel_2048 = _rel_err(torch, approx, dense32)
        cand = lsh.lsh_select(q, c0["pk"], a, kv_len=P, topk=T_lsh)  # (B, KV, T)
        chosen = torch.zeros((B, KV, P), dtype=torch.bool, device=dev)
        chosen.scatter_(2, cand, True)
        scores = torch.einsum("bhd,bshd->bhs", q[:, 0].float(),
                              c0["k"][:, :P].float().repeat_interleave(H // KV, dim=2))
        best = torch.topk(scores, 32, dim=-1).indices  # (B, H, 32)
        group = chosen.repeat_interleave(H // KV, dim=1)  # (B, H, P)
        coverage = float(torch.gather(group, 2, best).float().mean())
    del caches, c0, scores, chosen, group

    # -- (d) the smoke configs on the card and on the CPU port, float32 ---------
    smoke = {}
    cpu_mesh = make_host_mesh(device="cpu")
    for arch in LM_SMOKE_ARCHS:
        scfg = get_smoke_config(arch).replace(dtype=torch.float32)
        sp = tt.init_params(scfg, seed, device="cpu")
        kw = dict(batch=2, prompt_len=LM_SMOKE_PROMPT, gen=LM_SMOKE_GEN, seed=seed)
        want = serve_batch(scfg, cpu_mesh, params=sp, **kw)
        got = serve_batch(scfg, mesh, params=sp.to(dev), **kw)
        err = float((got["logits"].cpu() - want["logits"]).abs().max())
        scale = float(want["logits"].abs().max())
        check(np.array_equal(got["tokens"], want["tokens"]),
              f"lm_serve (d): {arch} greedy tokens on the card differ from the CPU port's")
        check(err <= LM_SMOKE_TOL * scale,
              f"lm_serve (d): {arch} logits differ by {err} > {LM_SMOKE_TOL * scale}")
        smoke[arch] = {"max_abs_err": err, "max_abs": scale}

    emit({"phase": "lm_serve", "arch": cfg.name, "layers": cfg.n_layers, "d_model": d,
          "heads": [H, KV], "head_dim": hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "dtype": "bfloat16", "lsh_topk": cfg.lsh_topk, "lsh_m": m, "batch": B,
          "prompt_len": P, "gen": G, "max_seq": max_seq, "params": n_params,
          "param_bytes": param_bytes, "cache_bytes": cache_bytes, "init_s": init_s,
          "peak_bytes_serving": peak_serve, "peak_bytes": torch.cuda.max_memory_allocated(),
          "serve_batch": {"prefill_s": out["prefill_s"],
                          "decode_s_per_token": out["decode_s_per_token"]},
          "prefill_ms": prefill_ms, "decode_ms_median": decode_med,
          "decode_ms_min": min(decode_ms), "decode_ms_max": max(decode_ms),
          "tokens_per_s": B / decode_med * 1e3, "repeat_tokens_identical": repeat_same,
          "bounds": {"decode_ms": decode_bound_ms, "decode_weight_bytes": weight_bytes,
                     "decode_kv_bytes": kv_gathered + pk_read,
                     "prefill_ms": max(prefill_bounds_ms.values()),
                     "prefill_parts_ms": prefill_bounds_ms, "prefill_bf16_flop": mm_flop,
                     "prefill_f32_attention_flop": attn_flop},
          "check_b": {"rel_err": rel_b, "corr": corr_b, "argmax_agree": argmax_b,
                      "tol_rel": LM_CONSISTENCY_REL, "tol_corr": LM_CONSISTENCY_CORR},
          "check_c": c_err, "lsh_2048": {"rel_err_vs_dense": rel_2048,
                                         "top32_coverage": coverage},
          "check_d": smoke, "first_request_tokens": tokens[0].tolist(),
          "decode_profile": decode_profile, "prefill_profile": prefill_profile,
          "seconds": time.perf_counter() - t_phase})
    return {"params": params, "cfg": cfg, "prompts": prompt_t, "first": tokens[:, 0],
            "base": base}


def held_bytes(torch) -> int:
    """The bytes the card's tensors hold: ``memory_allocated`` after a
    collection, without cuBLAS's workspace (which a matmul re-creates
    and which no step takes as an argument)."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def dryrun_cell(torch, name: str, cfg, shape, step, args: tuple, base: int, *,
                max_seq: int | None = None):
    """One cell of the ``dryrun`` phase: ``step(*args)`` on the card (its
    arguments, and nothing else since ``held_bytes`` read ``base``, on
    the card) under ``FlopCounterMode``, beside the dry run of the same
    cell at mesh (1, 1) on the meta device.  Checks the FLOPs equal, the
    argument bytes within DRYRUN_ARG_TOL and the peak inside
    DRYRUN_PEAK_BAND; returns the step's output and the cell's record."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun as dr

    t0 = time.perf_counter()
    held = held_bytes(torch) - base
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    card_flops = fc.get_total_flops()
    meta_step, meta_args, arg_bytes = dr.cell_step(cfg, shape, dr.rank_mesh(1, 1),
                                                   max_seq=max_seq)
    got = dr.trace(meta_step, meta_args)
    predicted = arg_bytes + got["temp"]
    rec = {"cell": name, "kind": shape.kind, "batch": shape.global_batch,
           "seq_len": shape.seq_len, "max_seq": max_seq, "meta_flops": got["flops"],
           "card_flops": card_flops, "argument_bytes": arg_bytes, "card_argument_bytes": held,
           "argument_rel_err": abs(arg_bytes - held) / held, "temp_bytes": got["temp"],
           "predicted_peak_bytes": predicted, "card_peak_bytes": peak,
           "peak_ratio": peak / predicted, "meta_bytes_read_written": got["bytes"],
           "meta_s": got["seconds"], "card_s": card_s, "seconds": time.perf_counter() - t0}
    check(got["flops"] == card_flops,
          f"dryrun: {name} FLOPs on meta {got['flops']} != {card_flops} on the card")
    check(rec["argument_rel_err"] <= DRYRUN_ARG_TOL,
          f"dryrun: {name} argument bytes {arg_bytes} against the card's {held}")
    lo, hi = DRYRUN_PEAK_BAND
    check(lo <= rec["peak_ratio"] <= hi,
          f"dryrun: {name} card peak {peak} over the predicted {predicted} = "
          f"{rec['peak_ratio']} outside {DRYRUN_PEAK_BAND}")
    return out, rec


def dryrun_serve_cells(torch, dev, lm: dict) -> list:
    """The ``dryrun`` phase's lm_serve cells on ``lm_serve``'s parameters
    and prompts (B = 4 × 4,096 into max_seq 4,128): the prefill, then one
    decode step at position 4,096 (a 0-d tensor, as the dry run's input
    specs give it) on the caches it filled.  Returns their records."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import make_host_mesh
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    cfg, params, prompts, base = lm["cfg"], lm["params"], lm["prompts"], lm["base"]
    B, P = prompts.shape
    max_seq = P + LM_GEN
    mesh = make_host_mesh(device=dev)
    prefill, _ = make_prefill(cfg, mesh, batch=B, seq_len=P, max_seq=max_seq)
    (logits, caches), pre = dryrun_cell(torch, "lm_serve_prefill", cfg,
                                        InputShape("lm_serve", P, B, "prefill"), prefill,
                                        (params, {"tokens": prompts}), base, max_seq=max_seq)
    batch = {"tokens": torch.argmax(logits, dim=-1).to(torch.int32),
             "position": torch.tensor(P, dtype=torch.int32, device=dev)}
    del logits
    decode, _ = make_decode_step(cfg, mesh, batch=B, max_seq=max_seq)
    dec = dryrun_cell(torch, "lm_serve_decode", cfg,
                      InputShape("lm_serve", max_seq, B, "decode"), decode,
                      (params, caches, batch), base)[1]
    del caches, batch
    gc.collect()
    torch.cuda.empty_cache()
    return [pre, dec]


def dryrun_phase(torch, cells: list) -> None:
    """Emit the ``dryrun`` line: the ``cells`` held to the card (run in
    lm_serve's and lm_train's state), then one production cell's record
    (``DRYRUN_PRODUCTION``) and its seconds."""
    from repro_torch.launch import dryrun as dr

    t0 = time.perf_counter()
    rec = dr.run_cell(*DRYRUN_PRODUCTION)
    production_s = time.perf_counter() - t0
    check(rec["status"] == "ok" and rec["hlo_flops"] > 0,
          f"dryrun: the production cell {DRYRUN_PRODUCTION}: {rec.get('error', rec)}")
    check(len(cells) == 3, f"dryrun: {len(cells)} cells held to the card, not 3")
    emit({"phase": "dryrun", "arg_tol": DRYRUN_ARG_TOL, "peak_band": DRYRUN_PEAK_BAND,
          "cells": cells, "production": rec, "production_s": production_s,
          "seconds": sum(c["seconds"] for c in cells) + production_s})


def lm_knn_phase(torch, dev, lm: dict, seed: int) -> None:
    """The kNN-LM pattern of ``examples/knn_serving.py`` at yi-6b's width:
    a datastore of the final hidden states of the 4 × 4,096 prompt tokens
    (d = 4096) keyed to their next tokens, served by
    ``make_retrieval_step`` over a ``flat`` index; 64 datastore keys as
    queries, k = 8."""
    from repro_torch.core import candidate_budget, select_seed
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts, ops, ref
    from repro_torch.kernels import verify as kver
    from repro_torch.models import transformer as tt
    from repro_torch.serve.serve_step import make_retrieval_step

    t_phase = time.perf_counter()
    params, cfg, prompts = lm["params"], lm["cfg"], lm["prompts"]
    with torch.inference_mode():
        hidden, _ = tt.forward(params, prompts, cfg, logits_slice="hidden")
    keys_t = hidden.float().reshape(-1, cfg.d_model)
    del hidden
    values = np.concatenate([prompts[:, 1:].cpu().numpy(), lm["first"][:, None]],
                            axis=1).reshape(-1)
    keys = keys_t.cpu().numpy()
    n, d = keys.shape
    config = IndexConfig(backend="flat", c=1.5, m=15, seed=seed)
    t0 = time.perf_counter()
    step, index = make_retrieval_step(keys, values, k=LM_KNN_K, index_config=config, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qids = np.random.default_rng(seed + 7).choice(n, LM_KNN_QUERIES, replace=False)
    queries = keys[qids]

    counts.reset()
    payloads, valid, dist, res = step(queries)
    launches = counts.snapshot()["launches"]
    for name in ("pairwise_sq_dist", "radius_select", "verify_topk"):
        check(launches[name] == 1, f"lm_knn: a search launched {name} {launches[name]} times")
    twin = build_index(keys, config.with_options(use_kernels=False), device=dev)
    plain = twin.search(queries, k=LM_KNN_K)
    check(np.array_equal(res.indices, plain.indices),
          "lm_knn: ids differ from the same index's use_kernels=False path")
    ties, own_first = 0, 0
    for i, qi in enumerate(qids):
        dup = int((keys_t == keys_t[int(qi)]).all(dim=1).sum())
        if dup > 1:  # another key equals this one: either may rank first
            ties += 1
            continue
        first = int(res.indices[i, 0]) == int(qi) and float(dist[i, 0]) <= LM_KNN_SELF_TOL
        check(first, f"lm_knn: query {i} (row {qi}) ranks {res.indices[i, :3]} at "
                     f"{dist[i, :3]}, not itself first")
        check(int(payloads[i, 0]) == int(values[qi]), f"lm_knn: query {i}'s payload")
        own_first += 1
    search_ms = time_ms(torch, lambda: step(queries), reps=7, warmup=1)

    # the path's stages by hand: verify at d = 4096 against its plain version
    impl = index.impl
    q_t = torch.from_numpy(queries).to(dev)
    d2p = ops.pairwise_sq_dist(impl.family.project(q_t), impl.projected)
    T = candidate_budget(impl.params, impl.n, LM_KNN_K)
    tau0 = select_seed(d2p, T, impl.params.m)
    _, cand, cnt = ops.radius_select(d2p, T, tau0=tau0, with_count=True)
    cand = cand.to(torch.int32).contiguous()
    vv, vi, rows_read = kver.verify_topk(impl.data, q_t, cand, LM_KNN_K, rows_read=True)
    pv, pi = ref.verify_topk(impl.data, q_t, cand, LM_KNN_K)
    check(torch.equal(vi, pi) and torch.allclose(vv, pv, rtol=1e-5, atol=1e-5),
          "lm_knn: verify_topk at d = 4096 differs from its plain version")
    check(np.array_equal(vi.cpu().numpy(), res.indices),
          "lm_knn: the stages by hand answer other ids than the search")
    gs = kver.group_size(LM_KNN_QUERIES, d)
    groups = [(int(torch.unique(c[c >= 0]).numel()), int((c >= 0).sum()))
              for c in cand.split(gs)]  # each query group's distinct rows and entries
    per_group = sum(u for u, _ in groups)
    uniq = int(torch.unique(cand[cand >= 0]).numel())
    check(int(rows_read) == per_group,
          f"lm_knn: verify read {int(rows_read)} rows, its groups hold {per_group} distinct")
    if gs >= LM_KNN_QUERIES:  # one group: each distinct row crosses from HBM once
        check(int(rows_read) == uniq,
              f"lm_knn: one group read {int(rows_read)} rows of {uniq} distinct")
    Bq = LM_KNN_QUERIES
    chunk = kver.chunk_size(Bq, d)
    traffic = kver.wide_traffic(d, Bq, gs, chunk,
                                torch.cuda.get_device_properties(0).multi_processor_count,
                                groups)
    t_bound, by = bound(4 * (uniq * d + Bq * d + Bq * T) + 8 * Bq * LM_KNN_K, 3 * Bq * T * d)
    emit({"phase": "lm_knn", "n": n, "d": d, "k": LM_KNN_K, "B": Bq, "build_s": build_s,
          "launches": {k: launches[k] for k in ("pairwise_sq_dist", "radius_select",
                                               "verify_topk")},
          "ids_identical_to_plain": True, "own_row_first": own_first, "tie_rows": ties,
          "self_tol": LM_KNN_SELF_TOL, "search_ms": search_ms, "T": T,
          "candidates_selected": int(cnt.sum()),
          "verify": {"rows_read": int(rows_read), "unique_rows": uniq, "group_size": gs,
                     "chunk": chunk, "traffic": traffic,
                     "max_abs_err": float((vv - pv).abs().max()),
                     "ms": time_ms(torch, lambda: kver.verify_topk(impl.data, q_t, cand,
                                                                   LM_KNN_K)),
                     "device_ms": device_ms(torch, lambda: kver.verify_topk(
                         impl.data, q_t, cand, LM_KNN_K)),
                     "plain_ms": time_ms(torch, lambda: ref.verify_topk(impl.data, q_t, cand,
                                                                        LM_KNN_K),
                                         reps=3, warmup=1),
                     "bound_ms": t_bound, "bound_by": by,
                     # the library form of the kernels line's verify row
                     "library_ms": time_ms(torch, lambda: torch.topk(
                         ((impl.data[cand.to(torch.int64)] - q_t[:, None, :]) ** 2).sum(-1),
                         LM_KNN_K, largest=False), reps=3, warmup=1)},
          "seconds": time.perf_counter() - t_phase})


def _cache_tensors(caches) -> list:
    """(name, tensor) of every cache and state tensor: a decoder's list of
    layer dicts, or the encoder-decoder's {"self": [...], "cross": [...]}."""
    if isinstance(caches, dict):
        return [(f"{part}{i}.{n}", t) for part, layers in caches.items()
                for i, c in enumerate(layers) for n, t in c.items()]
    return [(f"{i}.{n}", t) for i, c in enumerate(caches) for n, t in c.items()]


def _family_bounds(torch, cfg, params, caches, B: int, P: int, max_seq: int) -> dict:
    """The least time of a decode step and of the prefill, from this run's
    shapes.  Decode reads every weight once (B rows of the embedding) and
    the caches it needs: each recurrent state read and written, a local
    layer's window of keys, all the rows of a global one and the cross
    K/V.  Prefill: the bfloat16 matmul FLOP at the tensor-core peak, the
    float32 FLOP (attention over the padded key chunks the port computes,
    the mLSTM's chunk products, the float32 gate matrices) at the float32
    peak, and the bytes of the weights and the caches."""
    d, H, hd, Vp = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.padded_vocab()
    elt = torch.finfo(cfg.dtype).bits // 8
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    weight_bytes = param_bytes - params.embed.numel() * elt + B * d * elt
    cache_bytes, decode_cache = 0, 0
    for name, t in _cache_tensors(caches):
        size = t.numel() * t.element_size()
        cache_bytes += size
        kind = name.rsplit(".", 1)[-1]
        if kind in ("k", "v"):
            rows = min(cfg.window or max_seq, max_seq)
            decode_cache += size * rows // t.shape[1]
        elif kind in ("ck", "cv"):
            decode_cache += size
        else:
            decode_cache += 2 * size

    def pad(n):  # chunked attention computes whole 1,024-key chunks
        return -(-n // 1024) * 1024

    def mats(module, dtype):
        return sum(p.numel() for n, p in module.named_parameters()
                   if p.ndim >= 2 and p.dtype == dtype)

    bf16_flop = 2 * B * d * Vp  # the head on the last position
    f32_flop = 0
    if cfg.family == "encdec":
        M = cfg.n_audio_frames
        cross_kv = sum(p["xattn"][w].numel() for p in params.decoder for w in ("wk", "wv"))
        bf16_flop += 2 * B * M * (mats(params.encoder, cfg.dtype) + cross_kv)
        bf16_flop += 2 * B * P * (mats(params.decoder, cfg.dtype) - cross_kv)
        f32_flop += 4 * B * H * hd * (cfg.encoder_layers * M * pad(M)
                                      + cfg.n_layers * P * (pad(max_seq) + pad(M)))
    else:
        bf16_flop += 2 * B * P * mats(params.blocks, cfg.dtype)
        f32_flop += 2 * B * P * mats(params.blocks, torch.float32)
        L = min(64, P)
        dh = d // H
        for kind in params.kinds:
            if kind in ("attn", "local"):
                f32_flop += 4 * B * H * P * pad(max_seq) * hd
            elif kind == "mlstm":
                f32_flop += B * H * (P // L) * (4 * L * dh * dh + 6 * L * L * dh)
    prefill = {"bf16_matmul": bf16_flop / PEAK_BF16_PER_S * 1e3,
               "f32": f32_flop / PEAK_F32_PER_S * 1e3,
               "bytes": (param_bytes + cache_bytes) / PEAK_BYTES_PER_S * 1e3}
    return {"decode_ms": (weight_bytes + decode_cache) / PEAK_BYTES_PER_S * 1e3,
            "decode_weight_bytes": weight_bytes, "decode_cache_bytes": decode_cache,
            "prefill_ms": max(prefill.values()), "prefill_parts_ms": prefill,
            "prefill_bf16_flop": bf16_flop, "prefill_f32_flop": f32_flop,
            "param_bytes": param_bytes, "cache_bytes": cache_bytes}


def lm_family_model(torch, dev, arch: str, P: int, profile_prefill: bool, seed: int) -> dict:
    """One model of ``lm_families`` at its published widths and depth:
    ``serve_batch`` (check (a)), the same steps under CUDA events, a
    decode profile (and a prefill one where asked), check (b) and the
    bounds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model_module
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    t_model = time.perf_counter()
    cfg = get_config(arch)
    mod = model_module(cfg)
    encdec = cfg.family == "encdec"
    B, G, tail, Vp, d = LM_BATCH, LM_GEN, LM_FAMILY_TAIL, cfg.padded_vocab(), cfg.d_model
    widths = (cfg.n_layers, cfg.encoder_layers, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
              cfg.d_ff, cfg.vocab_size, cfg.rnn_width, cfg.conv1d_width, cfg.window)
    check(widths == LM_FAMILY_WIDTHS[arch] and cfg.dtype == torch.bfloat16,
          f"lm_families: {cfg.name} is not {arch}'s published configuration: {widths}")
    max_seq = P + G
    mesh = make_host_mesh(device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mod.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    layout = sum(p.numel() for p in mod.abstract_params(cfg).parameters())
    check(n_params == layout, f"lm_families: {cfg.name} has {n_params} parameters, "
                              f"its layout {layout}")

    # -- (a) serve_batch, then the same steps under CUDA events ----------------
    out = serve_batch(cfg, mesh, batch=B, prompt_len=P, gen=G, seed=seed, params=params)
    logits, tokens = out["logits"], out["tokens"]
    check(tuple(logits.shape) == (B, G, Vp) and bool(torch.isfinite(logits).all()),
          f"lm_families (a): {cfg.name} logits {tuple(logits.shape)} not all finite")
    check(tokens.shape == (B, G) and int(tokens.min()) >= 0 and int(tokens.max()) < Vp,
          f"lm_families (a): {cfg.name} tokens outside [0, {Vp})")
    del logits
    prefill, _ = make_prefill(cfg, mesh, batch=B, seq_len=P, max_seq=max_seq)
    decode, _ = make_decode_step(cfg, mesh, batch=B, max_seq=max_seq)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    prompt_t = torch.from_numpy(prompts).to(dev)
    batch_in = {"tokens": prompt_t}
    if encdec:  # seeded frames where serve_batch passes zeros
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch_in["audio_frames"] = torch.randn((B, cfg.n_audio_frames, d), generator=gen,
                                               device=dev).to(cfg.dtype)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 2)]
    ev[0].record()
    lg, caches = prefill(params, batch_in)
    ev[1].record()
    tok = torch.argmax(lg, dim=-1).to(torch.int32)
    for i in range(G):  # each step: the argmax before it and the decode
        lg, caches = decode(params, caches, {"tokens": tok, "position": P + i})
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        ev[i + 2].record()
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G)]
    decode_med = statistics.median(decode_ms)
    peak_serve = torch.cuda.max_memory_allocated()
    bounds = _family_bounds(torch, cfg, params, caches, B, P, max_seq)
    last = {"tokens": tok, "position": P + G - 1}
    decode_profile = profile_call(torch, lambda: decode(params, caches, last), decode_med,
                                  rows=8, pause=LM_PROFILE_PAUSE_S, traces=LM_PROFILE_TRACES)
    del caches, lg
    prefill_profile = None
    if profile_prefill:
        prefill_profile = profile_call(torch, lambda: prefill(params, batch_in), prefill_ms,
                                       rows=8, pause=LM_PROFILE_PAUSE_S)

    # -- (b) prefill S − 64, teacher-force the last 64 against the full pass ----
    with torch.inference_mode():
        full_caches = mod.init_cache(cfg, B, P, device=dev)
        if encdec:
            full, _ = mod.forward(params, prompt_t, batch_in["audio_frames"], cfg,
                                  caches=full_caches)
            want = full[:, P - tail:]
        else:  # the head on the last 64 rows only: all of them would be B·P·Vp floats
            hidden, _ = mod.forward(params, prompt_t, cfg, caches=full_caches,
                                    logits_slice="hidden")
            want = (hidden[:, P - tail:] @ params.head).float()
            del hidden
        caches = mod.init_cache(cfg, B, P, device=dev)
        head = prompt_t[:, :P - tail]
        if encdec:
            mod.forward(params, head, batch_in["audio_frames"], cfg, caches=caches,
                        logits_slice="last")
        else:
            mod.forward(params, head, cfg, caches=caches, logits_slice="last")
        rows = []
        for j in range(P - tail, P):
            lg, _ = mod.decode_step(params, caches, {"tokens": prompt_t[:, j:j + 1],
                                                     "position": j}, cfg)
            rows.append(lg[:, 0])
        got = torch.stack(rows, dim=1)
    rel_b, corr_b = _rel_err(torch, got, want), _corr(torch, got, want)
    argmax_b = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(rel_b <= LM_CONSISTENCY_REL and corr_b >= LM_CONSISTENCY_CORR,
          f"lm_families (b): {cfg.name} teacher-forced logits vs the full pass: relative "
          f"error {rel_b}, corr {corr_b}")
    state_err = {name: _rel_err(torch, t, w) for (name, t), (_, w)
                 in zip(_cache_tensors(caches), _cache_tensors(full_caches))}
    worst = max(state_err, key=state_err.get)
    check(state_err[worst] <= LM_CONSISTENCY_REL,
          f"lm_families (b): {cfg.name} state {worst} after teacher forcing differs from a "
          f"prefill of all {P} tokens by {state_err[worst]}")
    del caches, full_caches, got, want
    line = {"arch": cfg.name, "family": cfg.family, "widths": list(widths),
            "dtype": "bfloat16", "batch": B, "prompt_len": P, "gen": G, "max_seq": max_seq,
            "params": n_params, "param_count": cfg.param_count(), "init_s": init_s,
            "peak_bytes_serving": peak_serve, "peak_bytes": torch.cuda.max_memory_allocated(),
            "serve_batch": {"prefill_s": out["prefill_s"],
                            "decode_s_per_token": out["decode_s_per_token"]},
            "prefill_ms": prefill_ms, "decode_ms_median": decode_med,
            "decode_ms_min": min(decode_ms), "decode_ms_max": max(decode_ms),
            "tokens_per_s": B / decode_med * 1e3, "bounds": bounds,
            "check_b": {"rel_err": rel_b, "corr": corr_b, "argmax_agree": argmax_b,
                        "state_rel_err_max": state_err[worst], "state_worst": worst,
                        "tol_rel": LM_CONSISTENCY_REL, "tol_corr": LM_CONSISTENCY_CORR},
            "first_request_tokens": tokens[0].tolist(), "decode_profile": decode_profile,
            "prefill_profile": prefill_profile, "seconds": time.perf_counter() - t_model}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return line


def lm_families_phase(torch, dev, seed: int) -> None:
    """The hybrid, ssm and encdec families at their published widths and
    depth, one model at a time, then check (c): their smoke configs in
    float32 on the card and on the CPU port."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model_module

    t_phase = time.perf_counter()
    models = [lm_family_model(torch, dev, arch, P, prof, seed) for arch, P, prof in LM_FAMILIES]
    smoke = {}
    mesh, cpu_mesh = make_host_mesh(device=dev), make_host_mesh(device="cpu")
    for arch in LM_FAMILY_SMOKE:
        scfg = get_smoke_config(arch).replace(dtype=torch.float32)
        sp = model_module(scfg).init_params(scfg, seed, device="cpu")
        kw = dict(batch=2, prompt_len=LM_SMOKE_PROMPT, gen=LM_SMOKE_GEN, seed=seed)
        want = serve_batch(scfg, cpu_mesh, params=sp, **kw)
        got = serve_batch(scfg, mesh, params=sp.to(dev), **kw)
        err = float((got["logits"].cpu() - want["logits"]).abs().max())
        scale = float(want["logits"].abs().max())
        check(np.array_equal(got["tokens"], want["tokens"]),
              f"lm_families (c): {arch} greedy tokens on the card differ from the CPU port's")
        check(err <= LM_SMOKE_TOL * scale,
              f"lm_families (c): {arch} logits differ by {err} > {LM_SMOKE_TOL * scale}")
        smoke[arch] = {"max_abs_err": err, "max_abs": scale}
    emit({"phase": "lm_families", "models": models, "check_c": smoke,
          "seconds": time.perf_counter() - t_phase})


def _layer0_query(torch, params, cfg, tok, pos: int):
    """Layer 0's decode query for token ``tok`` at ``pos``, as
    ``attention_apply`` forms it (rms_norm, wq, RoPE)."""
    from repro_torch.models import layers as L

    blk = params.blocks[0]
    x = L.rms_norm(L.embed_lookup(params.embed, tok).to(cfg.dtype), blk["ln1"], cfg.norm_eps)
    B = tok.shape[0]
    q = (x @ blk["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    return L.rope(q, torch.tensor([pos], device=q.device), cfg.rope_theta)


def _plain_shard_positions(torch, q, pk, a, kv_len: int, topk: int, P: int):
    """The tournament's candidates recomputed plainly: shard by shard, the
    estimate of its rows, rows ≥ kv_len at −inf, a stable descending sort,
    its first ⌈T/P⌉ as global positions, in shard order."""
    B, _, H, _ = q.shape
    KV, m = pk.shape[2], pk.shape[3]
    Sl, Tl = pk.shape[1] // P, -(-topk // P)
    qg = (q.float() @ a.float()).reshape(B, KV, H // KV, m).mean(dim=2).to(pk.dtype).float()
    out = []
    for p in range(P):
        s = torch.einsum("bskm,bkm->bks", pk[:, p * Sl:(p + 1) * Sl].float(), qg)
        rows = p * Sl + torch.arange(Sl, device=s.device)
        s = torch.where(rows < kv_len, s, torch.full_like(s, float("-inf")))
        out.append(p * Sl + torch.sort(s, dim=-1, descending=True, stable=True)[1][..., :Tl])
    return torch.cat(out, dim=-1)


def _shard_decode(torch, cfg, params, P: int, dev, prompt, gen: int, max_seq: int,
                  tokens=None) -> dict:
    """make_prefill then ``gen`` steps of make_decode_step on an emulated
    mesh of P data shards; after each step layer 0's gathered positions
    (``lsh_decode_attention_sharded`` on the cache the step wrote) beside
    their plain recomputation.  ``tokens`` (B, gen) teacher-forces the
    steps; else each takes the argmax."""
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import lsh_attention as lsh
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    B, S = prompt.shape
    mesh = make_host_mesh(data=P, device=dev)
    pre, pinfo = make_prefill(cfg, mesh, batch=B, seq_len=S, max_seq=max_seq)
    dec, dinfo = make_decode_step(cfg, mesh, batch=B, max_seq=max_seq)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda" else None
    if ev:
        ev[0].record()
    lg, caches = pre(params, {"tokens": prompt})
    if ev:
        ev[1].record()
    steps, fed, pos_ok, positions = [lg], [], True, []
    for i in range(gen):
        tok = (torch.argmax(lg, dim=-1).to(torch.int32) if tokens is None
               else tokens[:, i:i + 1].to(dev))
        fed.append(tok)
        lg, caches = dec(params, caches, {"tokens": tok, "position": S + i})
        steps.append(lg)
        with torch.inference_mode():
            q0 = _layer0_query(torch, params, cfg, tok, S + i)
            c0, a = caches[0], params.blocks[0]["attn"]["lsh_a"]
            _, got = lsh.lsh_decode_attention_sharded(
                q0, c0["k"], c0["v"], c0["pk"], a, kv_len=S + i + 1, topk=cfg.lsh_topk,
                mesh=mesh, axis=dinfo["lsh_shard"], return_positions=True)
            want = _plain_shard_positions(torch, q0, c0["pk"], a, S + i + 1, cfg.lsh_topk, P)
        pos_ok = pos_ok and bool(torch.equal(got, want))
        positions.append(got.cpu())
    if ev:
        torch.cuda.synchronize()
    logits = torch.cat(steps, dim=1)
    del caches
    return {"forms": (pinfo["lsh_shard"], dinfo["lsh_shard"]), "logits": logits,
            "tokens": torch.cat(fed, dim=1).cpu(), "positions": torch.stack(positions),
            "positions_plain": pos_ok, "prefill_ms": ev[0].elapsed_time(ev[1]) if ev else None}


def _chunk_bound(cfg, params, S: int, start: int) -> dict:
    """The least time of a (1, S) chunk at ``start``: the bytes it must
    move (the weights but the embedding table, which gives S rows, and
    every layer's k and v rows up to start + S, read once; its k, v and
    pk rows written once) at the HBM rate, beside its operations — the
    bfloat16 matmuls of the blocks (the head on the last position alone)
    at the tensor cores' bfloat16 peak, and the causal attention's float32
    products over the keys each query may see (the port's attention runs
    in float32) at the float32 peak."""
    block_elems = sum(t.numel() for n, t in params.named_parameters() if n.startswith("blocks."))
    L, H, KV, hd, m = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.lsh_m
    d, Vp, el = cfg.d_model, cfg.padded_vocab(), 2
    head = Vp * d * el  # the head's (d, Vp) read once
    weight_bytes = block_elems * el + head + S * d * el
    kv_read = L * (start + S) * KV * hd * 2 * el
    written = L * S * KV * (2 * hd + m) * el
    bytes_moved = weight_bytes + kv_read + written
    mm_ops = 2 * S * block_elems + 2 * d * Vp
    keys = S * (start + 1) + S * (S - 1) // 2  # query i sees start + i + 1 keys
    attn_ops = L * 4 * H * hd * keys
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = (mm_ops / PEAK_BF16_PER_S + attn_ops / PEAK_F32_PER_S) * 1e3
    return {"ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "bf16_matmul_ops": mm_ops, "f32_attention_ops": attn_ops,
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def _chunk_rows(caches, lo: int, hi: int) -> list:
    """Copies of every layer's cache rows [lo, hi) (whole emulated caches)."""
    return [{n: t[:, lo:hi].clone() for n, t in c.items()} for c in caches]


def _chunk_against(torch, got_lg, got_rows, want_lg, want_rows, what: str) -> dict:
    """A chunk's last logits and cache rows against the one-device form's:
    layer 0's rows bit for bit, the logits within lm_serve's bfloat16
    bounds; the deeper layers' largest deviation, relative, printed."""
    check(all(torch.equal(t, want_rows[0][n]) for n, t in got_rows[0].items()),
          f"{what}: layer 0's cache rows differ from the one-device write")
    rel, corr = _rel_err(torch, got_lg, want_lg), _corr(torch, got_lg, want_lg)
    check(bool(torch.isfinite(got_lg).all()) and rel <= LM_CONSISTENCY_REL
          and corr >= LM_CONSISTENCY_CORR,
          f"{what}: last logits at relative L2 {rel}, correlation {corr} from one device's")
    deeper = max(float((t.float() - w[n].float()).abs().max()) / max(
        float(w[n].float().abs().max()), 1e-30)
        for c, w in zip(got_rows[1:], want_rows[1:]) for n, t in c.items())
    return {"logits_rel_l2": rel, "logits_corr": corr,
            "logits_max_abs_err": float((got_lg.float() - want_lg.float()).abs().max()),
            "layer0_rows_identical": True, "deeper_rows_max_rel_dev": deeper}


def _chunk_forms(torch, cfg, params, dev, prompt, chunk) -> dict:
    """lm_shard (a′): the prompt, then ``chunk`` at the prompt's end through
    make_decode_step, on one device and on each of LM_CHUNK_MESHES; each
    form's chunk ms (CUDA events) beside the chunk's bound."""
    from repro_torch.launch import make_host_mesh
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    S0, S = prompt.shape[1], chunk.shape[1]
    out, want = {}, None
    for shape in ((1, 1),) + LM_CHUNK_MESHES:
        D, M = shape
        mesh = make_host_mesh(M, data=D, device=dev)
        pre, _ = make_prefill(cfg, mesh, batch=1, seq_len=S0, max_seq=LM_SHARD_MAX_SEQ)
        dec, info = make_decode_step(cfg, mesh, batch=1, max_seq=LM_SHARD_MAX_SEQ)
        check(info["lsh_shard"] == (None if shape == (1, 1) else ("data", "model")),
              f"lm_shard (a′): {shape} took the form {info['lsh_shard']}")
        _, caches = pre(params, {"tokens": prompt})
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lg, caches = dec(params, caches, {"tokens": chunk, "position": S0})
        ev[1].record()
        torch.cuda.synchronize()
        row = {"form": info["lsh_shard"], "chunk_ms": ev[0].elapsed_time(ev[1])}
        if want is None:
            want = (lg, _chunk_rows(caches, 0, S0 + S))
        else:
            rows = _chunk_rows(caches, 0, S0 + S)
            row.update(_chunk_against(torch, lg, [{n: t[:, S0:] for n, t in c.items()}
                                                  for c in rows],
                                      want[0], [{n: t[:, S0:] for n, t in c.items()}
                                                for c in want[1]],
                                      f"lm_shard (a′) at {shape}"))
            if M == 1:  # the split prefill adds no float: every layer's prompt rows
                check(all(torch.equal(t[:, :S0], w[n][:, :S0])
                          for c, w in zip(rows, want[1]) for n, t in c.items()),
                      f"lm_shard (a′) at {shape}: the prefill's cache rows differ from one "
                      "device's")
                row["prefill_rows_identical"] = True
            del rows
        out[f"{D}x{M}"] = row
        del caches
    return out


def lm_shard_phase(torch, dev, seed: int) -> dict:
    """The sequence-sharded PM-LSH decode: (a) the entry points at yi-6b's
    full width on emulated data = 2, 4, 8 and the smoke config on the card
    against the CPU port; (a′) a 512-token chunk past the prompt on data =
    2, 4, 8 and (2, 2) against one device; (b) long_500k's shape at P =
    1, 2, 4, 8 from a cache drawn on the card, a 256-token chunk at
    524,024, then the decode; (c) an NCCL group of one against the
    emulated P = 1 form.  Returns layer 0's long_500k query, cache and
    budget."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import lsh_attention as lsh
    from repro_torch.models import transformer as tt
    from repro_torch.serve.serve_step import make_decode_step

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    H, KV, hd, m, T = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.lsh_m, cfg.lsh_topk
    check((cfg.n_layers, cfg.d_model, H, KV, hd, cfg.d_ff, cfg.vocab_size) == (
        32, 4096, 32, 4, 128, 11008, 64000) and cfg.dtype == torch.bfloat16
        and cfg.lsh_attention and T == 2048 and m == 16,
        f"lm_shard: {cfg.name} is not yi-6b's full configuration")
    params = tt.init_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed + 26)
    sharded = ("data", "model")

    # -- (a) the entry points on emulated data = 2, 4, 8 ------------------------
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LM_SHARD_PROMPT))
                              .astype(np.int32)).to(dev)
    entry = {}
    for P in LM_SHARD_P:
        torch.cuda.reset_peak_memory_stats()
        run = _shard_decode(torch, cfg, params, P, dev, prompt, LM_SHARD_GEN, LM_SHARD_MAX_SEQ)
        check(run["forms"] == (sharded, sharded),
              f"lm_shard (a): data = {P}, B = 1 took the forms {run['forms']}")
        check(bool(torch.isfinite(run["logits"]).all()),
              f"lm_shard (a): data = {P} logits not all finite")
        check(run["positions_plain"],
              f"lm_shard (a): data = {P} layer 0's gathered positions differ from the plain "
              "per-shard recomputation")
        entry[str(P)] = {"prefill_ms": run["prefill_ms"], "tokens": run["tokens"][0].tolist(),
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        del run
    # -- (a′) a chunk of 512 tokens past the prompt, against one device ----------
    crng = np.random.default_rng(seed + 27)
    chunk = torch.from_numpy(crng.integers(0, cfg.vocab_size, (1, LM_CHUNK))
                             .astype(np.int32)).to(dev)
    chunk_a = {"S": LM_CHUNK, "position": LM_SHARD_PROMPT,
               "bound": _chunk_bound(cfg, params, LM_CHUNK, LM_SHARD_PROMPT),
               "forms": _chunk_forms(torch, cfg, params, dev, prompt, chunk)}
    emit({"phase": "lm_shard_chunk", "case": "a", **chunk_a})
    gc.collect()
    torch.cuda.empty_cache()
    scfg = get_smoke_config(LM_ARCH).replace(dtype=torch.float32)
    sp = tt.init_params(scfg, seed, device="cpu")
    sprompt = torch.from_numpy(rng.integers(0, scfg.vocab_size, (1, LM_SHARD_SMOKE_PROMPT))
                               .astype(np.int32))
    sp_dev = tt.init_params(scfg, seed, device="cpu").to(dev)  # Module.to moves in place
    smoke = {}
    for P in LM_SHARD_P:
        want = _shard_decode(torch, scfg, sp, P, torch.device("cpu"), sprompt, LM_SHARD_GEN,
                             LM_SHARD_SMOKE_MAX_SEQ)
        got = _shard_decode(torch, scfg, sp_dev, P, dev, sprompt.to(dev), LM_SHARD_GEN,
                            LM_SHARD_SMOKE_MAX_SEQ, tokens=want["tokens"])
        err = float((got["logits"].cpu() - want["logits"]).abs().max())
        scale = float(want["logits"].abs().max())
        check(torch.equal(got["positions"], want["positions"]) and got["positions_plain"],
              f"lm_shard (a): smoke data = {P} gathered positions on the card differ from the "
              "CPU port's")
        check(err <= LM_SHARD_SMOKE_TOL * scale,
              f"lm_shard (a): smoke data = {P} logits differ by {err} > "
              f"{LM_SHARD_SMOKE_TOL * scale}")
        smoke[str(P)] = {"max_abs_err": err, "max_abs": scale}
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) long_500k's shape: a cache drawn on the card ------------------------
    S, kv_len = LM_LONG_SEQ, LM_LONG_KV
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    caches = tt.init_cache(cfg, 1, S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        for c, blk in zip(caches, params.blocks):
            c["k"].normal_(generator=gen)
            c["v"].normal_(generator=gen)
            # pk through attention_apply's projection of the cached keys
            c["pk"].copy_(torch.einsum("bskd,dm->bskm", c["k"].float(),
                                       blk["attn"]["lsh_a"].float()).to(cfg.dtype))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    pk_bytes = sum(c["pk"].numel() * c["pk"].element_size() for c in caches)
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    start = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1)).astype(np.int32)).to(dev)
    # the fill is taken to end at chunk0; the chunk writes rows [chunk0, kv_len)
    chunk0 = kv_len - LM_LONG_CHUNK
    lchunk = torch.from_numpy(crng.integers(0, cfg.vocab_size, (1, LM_LONG_CHUNK))
                              .astype(np.int32)).to(dev)
    long_bound = _chunk_bound(cfg, params, LM_LONG_CHUNK, chunk0)
    long, plain_chunk = {}, None
    for P in LM_LONG_P:
        mesh = make_host_mesh(data=P, device=dev)
        dec, info = make_decode_step(cfg, mesh, batch=1, max_seq=S)
        check(info["lsh_shard"] == (None if P == 1 else sharded),
              f"lm_shard (b): P = {P} took the form {info['lsh_shard']}")
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lg, caches = dec(params, caches, {"tokens": lchunk, "position": chunk0})
        ev[1].record()
        torch.cuda.synchronize()
        chunk_row = {"chunk_ms": ev[0].elapsed_time(ev[1])}
        rows = _chunk_rows(caches, chunk0, kv_len)
        if plain_chunk is None:
            check(bool(torch.isfinite(lg).all()), "lm_shard (b): the plain chunk's logits")
            plain_chunk = (lg, rows)
        else:
            chunk_row.update(_chunk_against(torch, lg, rows, *plain_chunk,
                                            f"lm_shard (b) chunk at P = {P}"))
        del rows, lg
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_LONG_GEN + 1)]
        tok, toks = start, []
        ev[0].record()
        for i in range(LM_LONG_GEN):
            lg, caches = dec(params, caches, {"tokens": tok, "position": kv_len + i})
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            toks.append(tok)
            ev[i + 1].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(LM_LONG_GEN)]
        check(bool(torch.isfinite(lg).all()), f"lm_shard (b): P = {P} logits not all finite")
        Tl = -(-T // P)
        cross_elems = P * Tl * KV * (2 * hd + 1)  # B = 1: k, v and a flag a candidate
        long[str(P)] = {
            "form": info["lsh_shard"], "decode_ms": ms, "decode_ms_median": statistics.median(ms),
            "tokens": torch.cat(toks, 1)[0].tolist(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "cross_elements_a_layer": None if P == 1 else cross_elems,
            "cross_bytes_a_layer": None if P == 1 else P * Tl * KV * (2 * hd * 2 + 1),
            "chunk": chunk_row}
    del plain_chunk
    # the bound: the weights but the embedding table (one row), pk's rows and
    # the T selected k and v rows of every layer, at the HBM rate
    kv_layer_bytes = 2 * S * KV * hd * 2
    sel_bytes = cfg.n_layers * KV * T * hd * 2 * 2
    weight_bytes = param_bytes - cfg.padded_vocab() * cfg.d_model * 2 + cfg.d_model * 2
    bound_bytes = weight_bytes + pk_bytes + sel_bytes
    bound_ms = bound_bytes / PEAK_BYTES_PER_S * 1e3

    # -- (c) an NCCL group of one against the emulated P = 1 form ----------------
    with torch.inference_mode():
        q0 = _layer0_query(torch, params, cfg, start, kv_len)
        c0, a = caches[0], params.blocks[0]["attn"]["lsh_a"]
        kw = dict(kv_len=kv_len, topk=T, axis="data", return_positions=True)
        out_e, pos_e = lsh.lsh_decode_attention_sharded(
            q0, c0["k"], c0["v"], c0["pk"], a, mesh=make_host_mesh(data=1, device=dev), **kw)
        store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1,
                                rank=0)
        try:
            gmesh = make_host_mesh(device="cuda")
            check(not gmesh.data.emulated and gmesh.shape == {"data": 1, "model": 1},
                  "lm_shard (c): the mesh is not the NCCL group")
            out_g, pos_g = lsh.lsh_decode_attention_sharded(q0, c0["k"], c0["v"], c0["pk"], a,
                                                            mesh=gmesh, **kw)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
    check(torch.equal(out_g, out_e) and torch.equal(pos_g, pos_e),
          "lm_shard (c): the NCCL group of one differs from the emulated P = 1 form")
    # layer 0's long_500k case is lm_tp (c)'s input
    long_case = {"q": q0, "k": c0["k"], "v": c0["v"], "pk": c0["pk"], "a": a,
                 "kv_len": kv_len, "topk": T}
    del caches, c0, q0
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "lm_shard", "arch": cfg.name, "dtype": "bfloat16", "lsh_topk": T,
          "lsh_m": m, "param_bytes": param_bytes,
          "check_a": {"prompt": LM_SHARD_PROMPT, "max_seq": LM_SHARD_MAX_SEQ,
                      "gen": LM_SHARD_GEN, "form": list(sharded), "data": entry,
                      "positions_plain": True, "smoke": smoke, "smoke_tol": LM_SHARD_SMOKE_TOL},
          "long_500k": {"batch": 1, "max_seq": S, "kv_len": kv_len, "gen": LM_LONG_GEN,
                        "cache": "seeded draws on the card to row 524,024, pk through the "
                                 "projection; rows 524,024-524,279 a 256-token chunk's",
                        "chunk": {"S": LM_LONG_CHUNK, "position": chunk0, "bound": long_bound},
                        "fill_s": fill_s, "cache_bytes": cache_bytes, "pk_bytes": pk_bytes,
                        "kv_bytes_a_layer": kv_layer_bytes, "by_P": long,
                        "bound": {"ms": bound_ms, "bytes": bound_bytes,
                                  "weight_bytes": weight_bytes, "selected_bytes": sel_bytes}},
          "check_c": {"backend": "nccl", "world_size": 1, "bit_for_bit": True},
          "seconds": time.perf_counter() - t_phase})
    return long_case


def lm_dp_train_phase(torch, dev, seed: int) -> None:
    """Data-parallel training of xlstm-125m at its published widths in
    float32: the one-device step, then emulated data = 2 and 4 and an
    NCCL group of one, each with the plain and the compressed steps."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import model_module
    from repro_torch.train import (
        AdamWConfig,
        init_opt_state,
        init_residuals,
        make_compressed_train_step,
        make_train_step,
    )
    from repro_torch.train import grad_compression as gcomp
    from repro_torch.train.train_step import batch_to_device, shard_losses_and_grads

    t_phase = time.perf_counter()
    full = get_config(LM_DP_ARCH)
    want_w = LM_FAMILY_WIDTHS[LM_DP_ARCH]
    check((full.n_layers, full.d_model, full.n_heads, full.vocab_size)
          == (want_w[0], want_w[2], want_w[3], want_w[7]),
          f"lm_dp_train: {full.name} is not xlstm-125m's configuration")
    cfg = full.replace(dtype=torch.float32, n_layers=LM_DP_LAYERS)
    mod = model_module(cfg)
    B, S = LM_DP_BATCH, LM_DP_SEQ
    batch = batch_to_device(SyntheticTokens(cfg.vocab_size, B, S, seed=seed).batch_at(0), dev)
    specs = {k: torch.empty((B, S), dtype=torch.int32, device="meta") for k in batch}
    ocfg = AdamWConfig()

    def steps(fn, residuals=None):
        """LM_DP_STEPS steps from the seeded state: losses, norms, ms."""
        params = mod.init_params(cfg, seed, device=dev)
        opt = init_opt_state(params)
        res = None if residuals is None else residuals(params)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_DP_STEPS + 1)]
        out = {"losses": [], "grad_norms": []}
        ev[0].record()
        for i in range(LM_DP_STEPS):
            if res is None:
                params, opt, m_ = fn(params, opt, batch)
            else:
                params, opt, res, m_ = fn(params, opt, res, batch)
            ev[i + 1].record()
            out["losses"].append(m_["loss"])
            out["grad_norms"].append(m_["grad_norm"])
        torch.cuda.synchronize()
        out = {k: [float(x) for x in v] for k, v in out.items()}
        out["step_ms"] = [ev[i].elapsed_time(ev[i + 1]) for i in range(LM_DP_STEPS)]
        return out

    def codes_on_host(mesh) -> bool:
        """The first compressed step's codes, scales and residuals of each
        local shard on the card against the CPU port on its gradients."""
        params = mod.init_params(cfg, seed, device=dev)
        _, grads = shard_losses_and_grads(params, batch, mesh, cfg=cfg)
        same = True
        for g in grads:
            for name, t in g.items():
                if t is None or t.numel() < gcomp.MIN_COMPRESSED:
                    continue
                zero = torch.zeros(t.shape, dtype=torch.float32, device=dev)
                card = gcomp.compress_with_feedback(t, zero)
                host = gcomp.compress_with_feedback(t.cpu(), zero.cpu())
                same = same and all(torch.equal(a.cpu(), b) for a, b in zip(card, host))
        return same

    # the bytes a shard hands each reduction of a step: float32 gradients;
    # int8 codes (a scale a compressed leaf, the small leaves in float32);
    # and what the psum of the codes moves as the reference writes it, in int32
    def wire(model_cfg) -> dict:
        numel = [p.numel() for p in model_module(model_cfg).abstract_params(
            model_cfg).parameters()]
        big = [n for n in numel if n >= gcomp.MIN_COMPRESSED]
        small = sum(numel) - sum(big)
        return {"params": sum(numel), "float32": 4 * sum(numel),
                "int8_codes": sum(big) + 4 * len(big) + 4 * small,
                "int32_psum_as_written": 4 * sum(big) + 4 * len(big) + 4 * small}

    torch.cuda.reset_peak_memory_stats()
    one_fn, one_info = make_train_step(cfg, make_host_mesh(device=dev), batch_specs=specs,
                                       opt_cfg=ocfg)
    check(not one_info["data_parallel"], "lm_dp_train: the one-device step split its batch")
    one = steps(one_fn)
    one["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(np.isfinite(one["losses"] + one["grad_norms"]).all(),
          f"lm_dp_train: one-device losses {one['losses']} not all finite")
    forms = {}

    def run_form(name, mesh, check_codes: bool):
        torch.cuda.reset_peak_memory_stats()
        fn, info = make_train_step(cfg, mesh, batch_specs=specs, opt_cfg=ocfg)
        check(info["data_parallel"], f"lm_dp_train: {name} did not split its batch")
        dp = steps(fn)
        dp["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        comp = steps(make_compressed_train_step(cfg, mesh, ocfg),
                     residuals=lambda p: init_residuals(p, mesh))
        comp["peak_bytes"] = torch.cuda.max_memory_allocated()
        l_err = abs(dp["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        n_err = abs(dp["grad_norms"][0] - one["grad_norms"][0]) / abs(one["grad_norms"][0])
        check(np.isfinite(dp["losses"] + comp["losses"] + comp["grad_norms"]).all(),
              f"lm_dp_train: {name} losses {dp['losses']} / {comp['losses']} not all finite")
        check(l_err <= LM_DP_TOL and n_err <= LM_DP_TOL,
              f"lm_dp_train: {name} first loss / grad norm off the one-device step's by "
              f"{l_err} / {n_err} > {LM_DP_TOL}")
        # one more forward and backward a shard: on two shards and on the group
        codes = codes_on_host(mesh) if check_codes else None
        check(codes is not False, f"lm_dp_train: {name} int8 codes, scales or residuals on the "
                                  "card differ from the CPU port's")
        forms[name] = {"shards": mesh.data.size, "emulated": mesh.data.emulated,
                       "dp": dp, "compressed": comp, "first_loss_rel_err": l_err,
                       "first_grad_norm_rel_err": n_err, "codes_bit_for_bit": codes}
        gc.collect()
        torch.cuda.empty_cache()

    for P in LM_DP_P:
        run_form(f"emulated{P}", make_host_mesh(data=P, device=dev), check_codes=P == 2)
    store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        gmesh = make_host_mesh(device="cuda")
        check(not gmesh.data.emulated, "lm_dp_train: the mesh is not the NCCL group")
        run_form("nccl1", gmesh, check_codes=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    emit({"phase": "lm_dp_train", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "vocab": cfg.vocab_size,
          "dtype": "float32", "batch": B, "seq_len": S, "steps": LM_DP_STEPS,
          "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
          "one_device": one, "forms": forms,
          "reduction_bytes_a_shard": {"run": wire(cfg), "published_depth": wire(full),
                                      "min_compressed": gcomp.MIN_COMPRESSED},
          "tol": LM_DP_TOL, "seconds": time.perf_counter() - t_phase})


def _tp_train_forms(torch, dev, seed: int) -> dict:
    """lm_tp (a): qwen3-moe-30b-a3b cut to LM_TP_LAYERS layers trained on
    each form from the same seeded state."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import model_module
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.train.train_step import batch_to_device, shard_params

    full = get_config(LM_TP_ARCH)
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.n_experts,
           full.n_experts_per_token, full.moe_d_ff, full.vocab_size, full.capacity_factor)
          == (48, 2048, 32, 4, 128, 8, 768, 151936, 1.25) and full.dtype == torch.bfloat16,
          f"lm_tp (a): {full.name} is not qwen3-moe-30b-a3b's configuration")
    cfg = full.replace(n_layers=LM_TP_LAYERS)
    mod = model_module(cfg)
    B, S = LM_TP_BATCH, LM_TP_SEQ
    batch = batch_to_device(SyntheticTokens(cfg.vocab_size, B, S, seed=seed).batch_at(0), dev)
    specs = {k: torch.empty((B, S), dtype=torch.int32, device="meta") for k in batch}
    ocfg = AdamWConfig()

    def run(name, mesh, fsdp: bool) -> dict:
        torch.cuda.reset_peak_memory_stats()
        fn, info = make_train_step(cfg, mesh, batch_specs=specs, opt_cfg=ocfg, fsdp=fsdp)
        params = mod.init_params(cfg, seed, device=dev)
        if info["parallel"] and not mesh.emulated:
            shard_params(params, mesh, info["layouts"])
        opt = init_opt_state(params)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_TP_STEPS + 1)]
        losses, norms = [], []
        ev[0].record()
        for i in range(LM_TP_STEPS):
            params, opt, m_ = fn(params, opt, batch)
            ev[i + 1].record()
            losses.append(m_["loss"])
            norms.append(m_["grad_norm"])
        torch.cuda.synchronize()
        out = {"mesh": list(mesh.axis_sizes), "emulated": mesh.emulated, "fsdp": fsdp,
               "parallel": info["parallel"], "sp": info["sp_spec"] is not None,
               "losses": [float(x) for x in losses], "grad_norms": [float(x) for x in norms],
               "step_ms": [ev[i].elapsed_time(ev[i + 1]) for i in range(LM_TP_STEPS)],
               "peak_bytes": torch.cuda.max_memory_allocated()}
        check(np.isfinite(out["losses"] + out["grad_norms"]).all(),
              f"lm_tp (a): {name} losses {out['losses']} not all finite")
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        return out

    forms = {"one_device": run("one device", make_host_mesh(device=dev), False)}
    check(not forms["one_device"]["parallel"], "lm_tp (a): the one-device step ran the layouts")
    for name, D, M, fsdp_sp in LM_TP_TRAIN_FORMS:
        forms[name] = run(name, make_host_mesh(M, data=D, device=dev), fsdp_sp)
        check(forms[name]["parallel"] and forms[name]["sp"],
              f"lm_tp (a): {name} did not run the layouts with SP (the reference's rule)")
    store = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        gmesh = make_host_mesh(device="cuda")
        check(not gmesh.emulated, "lm_tp (a): the mesh is not the NCCL group")
        forms["nccl1_fsdp"] = run("nccl1_fsdp", gmesh, True)
        check(forms["nccl1_fsdp"]["parallel"], "lm_tp (a): the NCCL group took the 1-D path")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    one = forms["one_device"]
    for name, f in forms.items():
        f["first_loss_rel_err"] = abs(f["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        f["first_grad_norm_rel_err"] = (abs(f["grad_norms"][0] - one["grad_norms"][0])
                                        / abs(one["grad_norms"][0]))
        check(f["first_loss_rel_err"] <= LM_TP_LOSS_TOL
              and f["first_grad_norm_rel_err"] <= LM_TP_NORM_TOL,
              f"lm_tp (a): {name} first loss / grad norm off the one-device step's by "
              f"{f['first_loss_rel_err']} / {f['first_grad_norm_rel_err']} > "
              f"{LM_TP_LOSS_TOL} / {LM_TP_NORM_TOL}")
    n_params = sum(p.numel() for p in mod.abstract_params(cfg).parameters())
    # a model-axis psum of one layer's forward: the attention's and the
    # experts' (B/D, S, d) partial outputs, bfloat16; SP moves the same
    # bytes as a reduce-scatter and an all-gather
    psum = {name: 2 * (B // f["mesh"][0]) * S * cfg.d_model * 2
            for name, f in forms.items() if f["mesh"][1] > 1}
    return {"arch": cfg.name, "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
            "params": n_params, "param_bytes_bf16": 2 * n_params,
            "moment_bytes_f32": 8 * n_params, "batch": B, "seq_len": S,
            "steps": LM_TP_STEPS, "capacity_factor": cfg.capacity_factor,
            "tol": {"loss": LM_TP_LOSS_TOL, "grad_norm": LM_TP_NORM_TOL},
            "forms": forms, "model_psum_bytes_a_layer_forward": psum}


def _tp_serve_forms(torch, dev, seed: int) -> dict:
    """lm_tp (b): the serving steps at full width on 2-D meshes against
    one device, and the caches' blocks as ``cache_pspecs`` lays them."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.sharding import cache_pspecs, local_shape
    from repro_torch.models import model_module
    from repro_torch.serve.serve_step import make_decode_step, make_prefill, step_form

    out = {}
    B, P, G, S = LM_BATCH, LM_TP_PROMPT, LM_TP_GEN, LM_TP_MAX_SEQ
    for arch, meshes in LM_TP_SERVE:
        cfg = get_config(arch)
        mod = model_module(cfg)
        params = mod.init_params(cfg, seed, device=dev)
        prompts = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, P)).astype(np.int32)).to(dev)

        def serve(mesh, tokens=None, model=None, mcfg=cfg, gen=G):
            model = params if model is None else model
            pre, _ = make_prefill(mcfg, mesh, batch=B, seq_len=P, max_seq=S)
            dec, _ = make_decode_step(mcfg, mesh, batch=B, max_seq=S)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 2)]
            ev[0].record()
            logits, caches = pre(model, {"tokens": prompts})
            ev[1].record()
            first, toks = logits, []
            for i in range(gen):
                t = (torch.argmax(logits, dim=-1).to(torch.int32) if tokens is None
                     else tokens[:, i:i + 1])
                toks.append(t)
                logits, caches = dec(model, caches, {"tokens": t, "position": P + i})
                ev[i + 2].record()
            torch.cuda.synchronize()
            del caches
            return {"first": first.float(), "last": logits.float(),
                    "tokens": torch.cat(toks, 1) if toks else None,
                    "prefill_ms": ev[0].elapsed_time(ev[1]),
                    "decode_ms": [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(gen)]}

        torch.cuda.reset_peak_memory_stats()
        one = serve(make_host_mesh(device=dev))
        entry = {"one_device": {"prefill_ms": one["prefill_ms"],
                                "decode_ms_median": statistics.median(one["decode_ms"]),
                                "peak_bytes": torch.cuda.max_memory_allocated()}}
        # the float32 twin of the same (bfloat16-rounded) weights, one device
        cfg32 = cfg.replace(dtype=torch.float32)
        twin = mod.init_params(cfg32, device="meta")
        for (name, w), (_, t) in zip(params.named_parameters(), twin.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            owner = twin.get_submodule(mod_name) if mod_name else twin
            owner._parameters[leaf] = torch.nn.Parameter(w.detach().float(),
                                                          requires_grad=False)
        ref = serve(make_host_mesh(device=dev), model=twin, mcfg=cfg32, gen=0)["first"]
        del twin
        gc.collect()
        torch.cuda.empty_cache()
        noise = float((one["first"] - ref).abs().max() / ref.abs().max())
        entry["one_device"]["first_logits_rel_err_to_f32"] = noise
        c_specs = mod.cache_specs(cfg, B, S)
        for D, M in meshes:
            mesh = make_host_mesh(M, data=D, device=dev)
            form = step_form(cfg, mesh, batch=B, max_seq=S)
            check(form["parallel"] and form["split"] == (D > 1),
                  f"lm_tp (b): {arch} at ({D}, {M}) took the form {form['parallel'], form['split']}")
            torch.cuda.reset_peak_memory_stats()
            got = serve(mesh, tokens=one["tokens"])
            rel = float((got["first"] - one["first"]).abs().max() / one["first"].abs().max())
            rel32 = float((got["first"] - ref).abs().max() / ref.abs().max())
            corr = _corr(torch, got["first"], one["first"])
            check(bool(torch.isfinite(got["last"]).all()),
                  f"lm_tp (b): {arch} at ({D}, {M}) logits not all finite")
            check(rel32 <= LM_TP_SERVE_NOISE * noise and corr >= LM_CONSISTENCY_CORR,
                  f"lm_tp (b): {arch} at ({D}, {M}) first logits {rel32} off the float32 "
                  f"twin's against one device's {noise} (× {LM_TP_SERVE_NOISE}), corr {corr}")
            # the blocks a shard holds, as cache_pspecs lays them out: rows
            # B/D, kv heads over 'model' where M divides them, else the width
            specs = cache_pspecs(c_specs, mesh, batch=B, max_seq=S)
            blocks = {}
            for c, sp in zip(c_specs, specs):
                for n, t in c.items():
                    blocks.setdefault(n, local_shape(tuple(t.shape), sp[n], mesh))
            KV, hd = cfg.n_kv_heads, cfg.head_dim
            kv_block = ((B // D, S, KV // M, hd) if KV % M == 0
                        else (B // D, S, KV, hd // M))
            check(blocks["k"] == kv_block,
                  f"lm_tp (b): {arch} at ({D}, {M}) k block {blocks['k']}, not {kv_block}")
            if "h" in blocks:
                rw = cfg.rnn_width or cfg.d_model
                check(blocks["h"] == (B // D, rw // M),
                      f"lm_tp (b): {arch} RG-LRU state block {blocks['h']}")
            entry[f"{D}x{M}"] = {"first_logits_rel_err": rel, "first_logits_corr": corr,
                                 "first_logits_rel_err_to_f32": rel32,
                                 "same_greedy_first": bool(torch.equal(
                                     torch.argmax(got["first"], -1),
                                     torch.argmax(one["first"], -1))),
                                 "prefill_ms": got["prefill_ms"],
                                 "decode_ms_median": statistics.median(got["decode_ms"]),
                                 "peak_bytes": torch.cuda.max_memory_allocated(),
                                 "cache_blocks": {n: list(v) for n, v in blocks.items()}}
        out[arch] = entry
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_tp_phase(torch, dev, long_case: dict, seed: int) -> None:
    """The ('data', 'model') mesh: (a) training with TP, EP, FSDP and SP,
    (b) serving on 2-D meshes, (c) the 2-D PM-LSH decode."""
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import lsh_attention as lsh

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    train = _tp_train_forms(torch, dev, seed)
    train["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = _tp_serve_forms(torch, dev, seed)
    serve_s = time.perf_counter() - t0

    # -- (c) the 2-D PM-LSH decode against the data = 8 form ---------------------
    x = long_case
    kw = dict(kv_len=x["kv_len"], topk=x["topk"], return_positions=True)
    with torch.inference_mode():
        want, wpos = lsh.lsh_decode_attention_sharded(
            x["q"], x["k"], x["v"], x["pk"], x["a"], mesh=make_host_mesh(data=8, device=dev),
            axis="data", **kw)
        lsh2d = {}
        for D, M in LM_TP_LSH:
            got, pos = lsh.lsh_decode_attention_sharded(
                x["q"], x["k"], x["v"], x["pk"], x["a"],
                mesh=make_host_mesh(M, data=D, device=dev), axis=("data", "model"), **kw)
            same = bool(torch.equal(got, want) and torch.equal(pos, wpos))
            check(same, f"lm_tp (c): the ({D}, {M}) decode differs from the data = 8 form")
            lsh2d[f"{D}x{M}"] = {"bit_for_bit": same, "positions": int(pos.numel())}
    emit({"phase": "lm_tp", "train": train,
          "serve": {"batch": LM_BATCH, "prompt": LM_TP_PROMPT, "max_seq": LM_TP_MAX_SEQ,
                    "gen": LM_TP_GEN, "by_arch": serve, "seconds": serve_s,
                    "noise_factor": LM_TP_SERVE_NOISE, "corr_tol": LM_CONSISTENCY_CORR},
          "lsh_2d": {"max_seq": LM_LONG_SEQ, "kv_len": x["kv_len"], "topk": x["topk"],
                     "by_mesh": lsh2d},
          "seconds": time.perf_counter() - t_phase})


def _train_bounds(cfg, params, opt, B: int, S: int) -> dict:
    """The least time of one training step, from this run's shapes.
    ``step_ms`` is the step's own: the bfloat16 matmuls (the layers' and
    the head's, forward and the backward's two products) at the
    tensor-core peak, plus flash attention's float32 products over the
    (query, key) pairs the causal mask keeps (QKᵀ and PV forward; QKᵀ,
    dV, dP, dQ, dK backward) at the float32 peak, or the bytes of the
    parameters and both moments, each read and written once, at the
    memory rate, the larger.  ``remat_ms`` is what remat="unit"'s
    recompute adds (a forward pass of the matmuls, the loss's slabs
    included, and of the kept pairs' two products); ``port_ms`` the work
    the port does: that too, and the masked pairs' nine products, since
    it computes every key chunk."""
    from repro_torch.models.transformer import layer_kinds

    d, H, hd, Vp = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.padded_vocab()
    mats = sum(p.numel() for n, p in params.blocks.named_parameters()
               if p.ndim == 2 and not n.endswith("lsh_a")) + d * Vp
    pass_flop = 2 * B * S * mats  # one pass of the bf16 matmuls
    pos = np.arange(S)
    kept = sum(int(np.minimum(pos + 1, (cfg.window if kind == "local" else 0) or S).sum())
               for kind in layer_kinds(cfg))  # causal (query, key) pairs, all layers
    pair_flop = 2 * B * H * hd  # one product's FLOP a pair
    masked = cfg.n_layers * S * S - kept
    flop = {"step": (3 * pass_flop, 7 * kept * pair_flop),
            "remat": (pass_flop, 2 * kept * pair_flop),
            "masked": (0, 9 * masked * pair_flop)}
    ms = {k: {"bf16_matmul": bf / PEAK_BF16_PER_S * 1e3,
              "f32_attention": f32 / PEAK_F32_PER_S * 1e3} for k, (bf, f32) in flop.items()}
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    moment_bytes = sum(t.numel() * t.element_size() for part in ("mu", "nu")
                       for t in opt[part].values())
    state_bytes = 2 * (param_bytes + moment_bytes)
    ops_ms, bytes_ms = sum(ms["step"].values()), state_bytes / PEAK_BYTES_PER_S * 1e3
    remat_ms = sum(ms["remat"].values())
    return {"step_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "parts_ms": {**ms["step"], "bytes": bytes_ms}, "remat_ms": remat_ms,
            "remat_parts_ms": ms["remat"],
            "port_ms": max(ops_ms + remat_ms + sum(ms["masked"].values()), bytes_ms),
            "masked_f32_attention_ms": ms["masked"]["f32_attention"],
            "bf16_flop": flop["step"][0], "f32_attention_flop": flop["step"][1],
            "remat_flop": list(flop["remat"]), "masked_f32_flop": flop["masked"][1],
            "causal_pairs": kept, "state_bytes_moved": state_bytes,
            "param_bytes": param_bytes, "moment_bytes": moment_bytes}


def _plain_attention(torch, q, k, v):
    """Causal softmax attention, GQA by repeating K/V over each group."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk, vv = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd**-0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def lm_train_phase(torch, dev, seed: int) -> dict:
    """The training path: (a) yi-6b at its published widths and depth
    through ``TrainLoop.run`` (losses, gradient norms, step ms, tokens/s,
    peak bytes, a profiled step, the bounds), then the ``dryrun`` phase's
    lm_train cell on its state (returns its record); (b) flash attention's
    backward at yi's attention shape against float64 autograd; (c) the
    ten smoke configs' AdamW steps on the card against the CPU port; (d)
    a checkpointed smoke run stopped and resumed against an unbroken
    one."""
    import shutil

    from repro_torch.configs import get_config, get_smoke_config, list_archs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import model_module
    from repro_torch.models.flash_attention import FlashAttention
    from repro_torch.configs.base import InputShape
    from repro_torch.train import AdamWConfig, adamw_update, init_opt_state, loss_and_grads
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import batch_to_device, train_step

    t_phase = time.perf_counter()
    mesh = make_host_mesh(device=dev)
    base = held_bytes(torch)  # before the state (the dry run's cell)

    # -- (a) yi-6b at its published widths, 4 steps through TrainLoop ----------
    cfg = get_config(LM_ARCH)
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    check((cfg.n_layers, d, H, KV, hd, cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 4, 128, 11008,
                                                                      64000)
          and cfg.dtype == torch.bfloat16, f"lm_train: {cfg.name} is not yi-6b's configuration")
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, mesh, batch=B, seq_len=S, seed=seed)
    t0 = time.perf_counter()
    out = loop.run(LM_TRAIN_STEPS, log_every=0)
    run_s = time.perf_counter() - t0
    losses, norms, step_ms = out["losses"], out["grad_norms"], out["step_ms"]
    check(len(losses) == LM_TRAIN_STEPS and np.isfinite(losses + norms).all(),
          f"lm_train (a): losses {losses}, gradient norms {norms} not all finite")
    peak = torch.cuda.max_memory_allocated()
    params, opt = out["params"], out["opt"]
    del out
    n_params = sum(p.numel() for p in params.parameters())
    step_med = statistics.median(step_ms[1:])
    bounds = _train_bounds(cfg, params, opt, B, S)
    batch = batch_to_device(loop.data.batch_at(LM_TRAIN_STEPS), dev)

    def one_step():  # the loop's step without its host reads
        _, grads = loss_and_grads(params, batch, cfg=cfg)
        adamw_update(loop.opt_cfg, params, grads, opt)

    profile = profile_call(torch, one_step, step_med, rows=8, pause=LM_PROFILE_PAUSE_S)

    # -- the dry run's lm_train cell: one more step of make_train_step's ------
    specs = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
             for k, v in batch.items()}
    step, _ = make_train_step(cfg, mesh, batch_specs=specs, opt_cfg=loop.opt_cfg)
    dry = dryrun_cell(torch, "lm_train", cfg, InputShape("lm_train", S, B, "train"), step,
                      (params, opt, batch), base)[1]
    del loop, params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) flash attention's backward at yi's attention shape ---------------
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, dout = (torch.randn((1, S, H, hd), generator=gen, device=dev) for _ in range(2))
    k, v = (torch.randn((1, S, KV, hd), generator=gen, device=dev) for _ in range(2))
    flash = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ins = [t.detach().to(dt).requires_grad_() for t in (q, k, v)]
        FlashAttention.apply(*ins, True, 0, 1024).backward(dout.to(dt))
        ref = [t.detach().to(dt).double().requires_grad_() for t in (q, k, v)]
        _plain_attention(torch, *ref).backward(dout.to(dt).double())
        flash[name] = {g: _rel_err(torch, a.grad.double(), b.grad)
                       for g, a, b in zip(("dq", "dk", "dv"), ins, ref)}
        del ins, ref
        torch.cuda.empty_cache()
    worst = max(flash["float32"].values())
    check(worst <= LM_TRAIN_FLASH_TOL,
          f"lm_train (b): float32 flash gradients {flash['float32']} against float64 > "
          f"{LM_TRAIN_FLASH_TOL}")
    del q, k, v, dout

    # -- (c) the ten smoke configs: AdamW steps on the card against the CPU ---
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=0)
    smoke = {}
    for arch in list_archs():
        scfg = get_smoke_config(arch).replace(dtype=torch.float32)
        mod = model_module(scfg)
        batch = SyntheticTokens(scfg.vocab_size, 2, 32, seed=seed).batch_at(0)
        rng = np.random.default_rng(seed)
        for name, rows in (("image_embeds", scfg.n_image_tokens),
                           ("audio_frames", scfg.n_audio_frames)):
            if name == {"vlm": "image_embeds", "encdec": "audio_frames"}.get(scfg.family):
                batch[name] = (rng.normal(size=(2, rows, scfg.d_model)) * 0.1).astype(np.float32)
        runs = {}
        for where in ("cpu", dev):
            params = mod.init_params(scfg, seed, device="cpu").to(where)
            opt, b = init_opt_state(params), batch_to_device(batch, torch.device(where))
            runs[str(where)] = []
            for _ in range(LM_TRAIN_SMOKE_STEPS):
                params, opt, metrics = train_step(params, opt, b, cfg=scfg, opt_cfg=ocfg)
                runs[str(where)].append(float(metrics["loss"]))
        want, got = runs["cpu"], runs[str(dev)]
        err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        check(np.isfinite(got).all() and err <= LM_TRAIN_SMOKE_TOL and got[-1] < got[0],
              f"lm_train (c): {arch} losses on the card {got}, on the CPU {want}")
        smoke[arch] = {"losses": got, "max_rel_err": err}

    # -- (d) checkpoint every 2 steps, stop at 4, resume to 6 ------------------
    scfg = get_smoke_config(LM_ARCH)
    root = os.path.join(ROOT, "build", "lm_train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(batch=2, seq_len=32, seed=seed)
    stop, end = LM_TRAIN_RESUME_STEPS
    try:
        whole = TrainLoop(scfg, mesh, **kw).run(end, log_every=0)["losses"]
        first = TrainLoop(scfg, mesh, ckpt_dir=root, ckpt_every=LM_TRAIN_RESUME_EVERY,
                          **kw).run(stop, log_every=0)["losses"]
        again = TrainLoop(scfg, mesh, ckpt_dir=root, ckpt_every=LM_TRAIN_RESUME_EVERY, **kw)
        rest = again.run(end, log_every=0)["losses"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(again.restarts == 1 and first + rest == whole,
          f"lm_train (d): resumed losses {first} + {rest} (restarts {again.restarts}) are not "
          f"the unbroken run's {whole}")

    emit({"phase": "lm_train", "arch": cfg.name, "layers": cfg.n_layers, "d_model": d,
          "heads": [H, KV], "head_dim": hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "dtype": "bfloat16", "moments": "float32", "batch": B, "seq_len": S,
          "remat": "unit", "steps": LM_TRAIN_STEPS, "reduced": {}, "params": n_params,
          "losses": losses, "grad_norms": norms, "step_ms": step_ms,
          "step_ms_median_2_4": step_med, "tokens_per_s": B * S / step_med * 1e3,
          "run_s": run_s, "peak_bytes": peak, "peak_gib": peak / 2**30,
          "card_bytes": torch.cuda.get_device_properties(dev).total_memory,
          "bounds": bounds, "step_ms_over_bound": step_med / bounds["step_ms"],
          "step_ms_over_port_work": step_med / bounds["port_ms"],
          "tokens_per_s_bound": B * S / bounds["step_ms"] * 1e3, "profile": profile,
          "check_b": {"flash_rel_l2": flash, "tol": LM_TRAIN_FLASH_TOL},
          "check_c": {"archs": smoke, "tol": LM_TRAIN_SMOKE_TOL},
          "check_d": {"whole": whole, "first": first, "resumed": rest},
          "seconds": time.perf_counter() - t_phase})
    return dry


ENTRY_POINTS = (("quickstart", "examples/torch_quickstart.py"),
                ("check_api", "scripts/torch_check_api.py"),
                ("chaos_drill", "scripts/torch_chaos_drill.py"))
ENTRY_POINT_KERNELS = {"quickstart": ("pairwise_sq_dist", "pair_join")}


def load_twin(name: str, rel: str):
    """An entry-point twin under examples/ or scripts/, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"entry_{name}", os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin_main(torch, mod, argv: list, rel: str) -> tuple:
    """``mod.main(argv)`` in-process, its stdout captured and its ``run``
    (where it has one) wrapped to keep each result: (results, printed
    lines, seconds, launches by kernel, counts set to 0 before it);
    checks its rc."""
    from repro_torch.kernels import counts

    results, real = [], getattr(mod, "run", None)
    if real is not None:
        def keep(*args, **kw):
            results.append(real(*args, **kw))
            return results[-1]

        mod.run = keep
    out = io.StringIO()
    counts.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(out.getvalue(), file=sys.stderr, flush=True)
        raise
    finally:
        if real is not None:
            mod.run = real
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(out.getvalue(), file=sys.stderr, flush=True)
    check(rc == 0, f"{rel} returned {rc}")
    return results, out.getvalue().splitlines(), seconds, dict(counts.LAUNCHES)


def entry_points_phase(torch, dev) -> None:
    """Each entry-point twin's ``main`` on the card, in-process: its rc,
    seconds, last printed line and launches by kernel."""
    for name, rel in ENTRY_POINTS:
        _, lines, seconds, launches = twin_main(torch, load_twin(name, rel),
                                                ["--device", str(dev)], rel)
        emit({"phase": "entry_points", "entry": name, "script": rel, "rc": 0,
              "seconds": seconds, "last_line": lines[-1] if lines else "",
              "launches": launches})
        for kernel in ENTRY_POINT_KERNELS.get(name, ()):
            check(launches[kernel] > 0, f"{rel} launched no {kernel}")


LM_EXAMPLES = (("knn_serving", "examples/torch_knn_serving.py"),
               ("long_context", "examples/torch_long_context.py"),
               ("train_lm", "examples/torch_train_lm.py"))
# what the knn twin's streaming datastore launches, as a CPU dry count of
# its dispatches predicts it: the delta scan's pairwise and topk and the
# merges' topk (its pmtree segment is host work)
LM_EXAMPLE_KERNELS = {"knn_serving": ("pairwise_sq_dist", "topk_smallest")}
LM_EXAMPLES_CKPT = os.path.join("build", "train_lm")
LM_EXAMPLES_TRAIN = (300, 8, 256)  # torch_train_lm's defaults: steps, batch, seq_len
LM_EXAMPLES_LSH = dict(lsh_attention=True, lsh_topk=256, lsh_m=16)  # long_context's


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _within_largest(got: np.ndarray, want: np.ndarray, tol: float) -> tuple[float, float]:
    """The largest |got − want| and the bound ``tol`` × the largest |want|."""
    return float(np.abs(got - want).max()), tol * float(np.abs(want).max())


def lm_examples_phase(torch, dev, seed: int) -> None:
    """The LM examples' twins on the card: (a) each ``main`` at its own
    sizes (train_lm at its full defaults); (b) the smoke config in
    float32 on the card against the CPU port; (c) yi-6b at its full
    width through the knn and long_context twins' ``run``."""
    import copy
    import shutil

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import checkpoint as ckpt
    from repro_torch.models import transformer as tt

    t_phase = time.perf_counter()
    twins = {name: load_twin(name, rel) for name, rel in LM_EXAMPLES}
    rels = dict(LM_EXAMPLES)
    argv = ["--device", str(dev)]

    def line(name, lines, seconds, launches, **extra):
        emit({"phase": "lm_examples", "part": "own_sizes", "entry": name,
              "script": rels[name], "rc": 0, "seconds": seconds,
              "last_line": lines[-1] if lines else "", "launches": launches, **extra})

    # -- (a) each twin's main at its own sizes ---------------------------------
    (knn,), lines, secs, launches = twin_main(torch, twins["knn_serving"], argv,
                                              rels["knn_serving"])
    evicted_back = sorted(set(knn["ids_after"].tolist()) & set(knn["evicted"].tolist()))
    line("knn_serving", lines, secs, launches, ids=knn["ids"].tolist(), row=knn["row"],
         distances=knn["distances"].tolist(), n=knn["n"], evicted_back=evicted_back)
    check(len(lines) == 4 and knn["ids"][0] == knn["row"] and knn["tokens"][0] == knn["payload"],
          f"lm_examples (a): knn's own key {knn['row']} is not first with its payload: "
          f"{knn['ids'].tolist()}")
    check(knn["n"] == 2504, f"lm_examples (a): the knn datastore grew to {knn['n']}, not 2504")
    check(not evicted_back, f"lm_examples (a): evicted ids {evicted_back} came back")
    for kernel in LM_EXAMPLE_KERNELS["knn_serving"]:
        check(launches[kernel] > 0, f"lm_examples (a): knn_serving launched no {kernel}")

    (dense, lsh), lines, secs, launches = twin_main(torch, twins["long_context"], argv,
                                                    rels["long_context"])
    line("long_context", lines, secs, launches,
         ms_per_token={"dense": dense["ms_per_token"], "lsh": lsh["ms_per_token"]},
         ms_median={"dense": dense["ms_median"], "lsh": lsh["ms_median"]},
         tokens={"dense": dense["tokens"].tolist(), "lsh": lsh["tokens"].tolist()})
    check(len(lines) == 3, f"lm_examples (a): long_context printed {lines}")
    del dense, lsh

    steps, B, S = LM_EXAMPLES_TRAIN
    root = os.path.join(ROOT, LM_EXAMPLES_CKPT)
    shutil.rmtree(root, ignore_errors=True)
    try:
        (tr,), lines, secs, launches = twin_main(
            torch, twins["train_lm"], argv + ["--steps", str(steps), "--batch", str(B),
                                              "--seq-len", str(S), "--ckpt-dir", root],
            rels["train_lm"])
        latest = ckpt.latest_step(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = twins["train_lm"].yi_100m()
    losses, step_ms, restarts = tr["losses"], tr["step_ms"], tr["restarts"]
    n_params = sum(p.numel() for p in tr["params"].parameters())
    bounds = _train_bounds(cfg, tr["params"], tr["opt"], B, S)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    step_med = statistics.median(step_ms[1:])
    line("train_lm", lines, secs, launches, header=lines[0], params=n_params,
         param_count=cfg.param_count(), steps=len(losses), batch=B, seq_len=S,
         first_loss=losses[0], last_loss=losses[-1], latest_step=latest, restarts=restarts,
         step_ms_median=step_med, step_ms_first=step_ms[0],
         tokens_per_s=B * S / step_med * 1e3, bound_ms=bounds["step_ms"],
         bound_by=bounds["bound_by"], bound_parts_ms=bounds["parts_ms"],
         port_work_ms=bounds["port_ms"], step_ms_over_bound=step_med / bounds["step_ms"],
         tokens_per_s_bound=B * S / bounds["step_ms"] * 1e3)
    check(lines[0] == f"training yi-100m: 125M params, {steps} steps, batch {B} × seq {S}",
          f"lm_examples (a): train_lm's header reads {lines[0]!r}")
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"lm_examples (a): train_lm took {len(losses)} steps, finite: "
          f"{bool(np.isfinite(losses).all())}")
    check(losses[-1] < losses[0], f"lm_examples (a): train_lm's last loss {losses[-1]} is not "
                                  f"below its first {losses[0]}")
    check(latest == steps, f"lm_examples (a): the latest committed step is {latest}, not {steps}")

    # -- (b) the smoke config in float32: the card against the CPU port -------
    smoke = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    vs_cpu = {}
    for label, over in (("dense attention", dict(lsh_attention=False)),
                        ("PM-LSH retrieval attn", LM_EXAMPLES_LSH)):
        scfg = smoke.replace(**over)
        on_card = tt.init_params(scfg, seed, device=dev)
        on_cpu = copy.deepcopy(on_card).to("cpu")
        got, want = (_quiet(twins["long_context"].run, scfg, label, device=where, params=params)
                     for where, params in ((dev, on_card), ("cpu", on_cpu)))
        errs = {step: _within_largest(got[step].cpu().numpy(), want[step].numpy(), LM_SMOKE_TOL)
                for step in ("first", "last")}
        vs_cpu[label] = {"tokens_identical": bool(np.array_equal(got["tokens"], want["tokens"])),
                         "max_abs_err": {k: e for k, (e, _) in errs.items()},
                         "bound": {k: b for k, (_, b) in errs.items()}}
        check(vs_cpu[label]["tokens_identical"],
              f"lm_examples (b): {label} tokens on the card {got['tokens'].tolist()}, on the "
              f"CPU {want['tokens'].tolist()}")
        for step, (err, bound_) in errs.items():
            check(err <= bound_, f"lm_examples (b): {label} {step} logits differ by {err} > "
                                 f"{bound_}")
        if not scfg.lsh_attention:  # the knn twin's dense model
            kg = _quiet(twins["knn_serving"].run, dev, cfg=scfg, params=on_card)
            kc = _quiet(twins["knn_serving"].run, "cpu", cfg=scfg, params=on_cpu)
            err, bound_ = _within_largest(kg["distances"], kc["distances"], LM_SMOKE_TOL)
            same = (np.array_equal(kg["ids"], kc["ids"])
                    and np.array_equal(kg["ids_after"], kc["ids_after"]))
            vs_cpu["knn"] = {"ids_identical": same, "max_abs_err": err, "bound": bound_}
            check(same, f"lm_examples (b): knn ids on the card {kg['ids'].tolist()} / "
                        f"{kg['ids_after'].tolist()}, on the CPU {kc['ids'].tolist()} / "
                        f"{kc['ids_after'].tolist()}")
            check(err <= bound_, f"lm_examples (b): knn distances differ by {err} > {bound_}")
        del on_card, on_cpu, got, want
    emit({"phase": "lm_examples", "part": "card_vs_cpu", "arch": smoke.name, "dtype": "float32",
          "tol": LM_SMOKE_TOL, "runs": vs_cpu})

    # -- (c) yi-6b at its full width, one parameter set on the card at a time --
    full = get_config(LM_ARCH)
    Vp, d = full.padded_vocab(), full.d_model
    check((full.n_layers, d, full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
           full.vocab_size) == (32, 4096, 32, 4, 128, 11008, 64000)
          and full.dtype == torch.bfloat16, f"lm_examples (c): {full.name} is not yi-6b")
    torch.cuda.reset_peak_memory_stats()
    wide = {}
    for label, over in (("dense attention", dict(lsh_attention=False)),
                        ("PM-LSH retrieval attn", LM_EXAMPLES_LSH)):
        cfg_c = full.replace(**over)
        t0 = time.perf_counter()
        params = tt.init_params(cfg_c, seed, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
        weight_bytes = param_bytes - Vp * d * 2 + d * 2  # the embedding: one row a token
        row = {"init_s": init_s, "param_bytes": param_bytes,
               "bound_ms": weight_bytes / PEAK_BYTES_PER_S * 1e3}
        if not cfg_c.lsh_attention:
            t0 = time.perf_counter()
            kf = _quiet(twins["knn_serving"].run, dev, cfg=cfg_c, params=params)
            row["knn"] = {"seconds": time.perf_counter() - t0, "keys": 2016, "n": kf["n"],
                          "ids": kf["ids"].tolist(), "own_distance": float(kf["distances"][0]),
                          "evicted_back": sorted(set(kf["ids_after"].tolist())
                                                 & set(kf["evicted"].tolist()))}
            check(kf["ids"][0] == kf["row"] and kf["tokens"][0] == kf["payload"]
                  and kf["n"] == 2504 and not row["knn"]["evicted_back"],
                  f"lm_examples (c): knn at d = {d}: {row['knn']}")
        t0 = time.perf_counter()
        out = _quiet(twins["long_context"].run, cfg_c, label, device=dev, params=params)
        row.update(seconds=time.perf_counter() - t0, line=out["line"],
                   ms_per_token=out["ms_per_token"], ms_median=out["ms_median"],
                   step_ms=out["step_ms"], tokens=out["tokens"].tolist())
        row["ms_over_bound"] = out["ms_median"] / row["bound_ms"]
        wide[label] = (row, out["first"], out["last"])
        del params, out
        gc.collect()
        torch.cuda.empty_cache()
    (d_row, d_first, d_last), (l_row, l_first, l_last) = wide.values()
    corr_first, rel_first = _corr(torch, l_first, d_first), _rel_err(torch, l_first, d_first)
    emit({"phase": "lm_examples", "part": "full_width", "arch": full.name, "layers": full.n_layers,
          "d_model": d, "dtype": "bfloat16", "ctx_len": 8192, "prefill_len": 64,
          "dense": d_row, "lsh": {**l_row, **LM_EXAMPLES_LSH},
          "first_step": {"corr": corr_first, "rel_l2": rel_first,
                         "tol_corr": LM_CONSISTENCY_CORR, "tol_rel": LM_CONSISTENCY_REL},
          "last_step_corr": _corr(torch, l_last, d_last),
          "peak_bytes": torch.cuda.max_memory_allocated()})
    check(corr_first >= LM_CONSISTENCY_CORR and rel_first <= LM_CONSISTENCY_REL,
          f"lm_examples (c): the first decode step's logits, dense against LSH: corr "
          f"{corr_first}, relative L2 {rel_first}")
    emit({"phase": "lm_examples", "seconds": time.perf_counter() - t_phase})


def index_phases(torch, dev, seed: int) -> None:
    """Every phase of the index side, from the Deep1M twin's data to the
    durable stream, on kernels already built."""
    from repro_torch.core import ann_query, candidate_budget, select_seed
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import counts, ops, ref
    from repro_torch.kernels import pairwise_dist as kpair
    from repro_torch.kernels import project_dist as kproj
    from repro_torch.kernels import select as ksel
    from repro_torch.kernels import topk as ktopk
    from repro_torch.kernels import verify as kver

    # -- data and index ----------------------------------------------------
    t0 = time.perf_counter()
    data = make_clustered_twin(N_POINTS, DIM, seed)
    queries = make_queries(data, max(BATCHES), seed + 1)
    index = build_index(data, IndexConfig(backend="flat", seed=seed), device=dev)
    impl = index.impl
    torch.cuda.synchronize()
    T = candidate_budget(impl.params, impl.n, K)
    T_pad = min(T + max(256, T // 8), impl.n)
    emit({"phase": "data", "n": impl.n, "d": impl.d, "m": impl.m,
          "beta": impl.params.beta, "T": T, "T_pad": T_pad,
          "data_bytes": impl.data.numel() * 4,
          "projected_bytes": impl.projected.numel() * 4,
          "seconds": time.perf_counter() - t0})

    # -- parity at the main path's shapes (B = 64) and at edge shapes -------
    q64 = torch.from_numpy(queries).to(dev)
    qp = impl.family.project(q64)
    d2p = kpair.pairwise_sq_dist(qp, impl.projected)
    d2p_plain = ref.pairwise_sq_dist(qp, impl.projected)
    pw_err = float((d2p - d2p_plain).abs().max())
    # the norm trick's float32 cancellation scales with |q|² + |x|²
    pw_tol = 1e-5 * float((qp * qp).sum(1).max() + (impl.projected ** 2).sum(1).max())
    check(pw_err <= pw_tol, f"pairwise_sq_dist: max |diff| {pw_err} > {pw_tol}")

    tau0 = select_seed(d2p, T, impl.m)
    sel = ksel.radius_select(d2p, tau0, T)
    sel_plain = ref.radius_select_exact(d2p, tau0, T)
    sel_same = all(torch.equal(a, b) for a, b in zip(sel, sel_plain))
    sel_err = float((sel[0] - sel_plain[0]).nan_to_num(0.0).abs().max())  # inf − inf: 0
    check(sel_same, "radius_select: vals, idx or counts differ from the plain version")
    check(bool((sel[2] <= T_pad).all()) and bool((sel[2] >= T).all()),
          f"radius_select: counts {sel[2].min().item()}..{sel[2].max().item()} "
          f"outside [T, T_pad]")
    # the ordered route: the reference's kernel and trim, ascending
    ordered = ops.radius_select(d2p, T, tau0=tau0, with_count=True)
    check(all(torch.equal(a, b) for a, b in zip(
        ordered, ops.radius_select(d2p, T, tau0=tau0, with_count=True, force="plain"))),
          "radius_select: the ordered route differs from the plain route")
    del ordered
    cand = sel[1]  # the fused path's candidates: the kernel's index order

    ver_v, ver_i, rows_read = kver.verify_topk(impl.data, q64, cand, K, rows_read=True)
    ver_plain = ref.verify_topk(impl.data, q64, cand, K)
    ver_ids_same = torch.equal(ver_i, ver_plain[1])
    ver_err = float((ver_v - ver_plain[0]).abs().max())
    check(ver_ids_same, "verify_topk: ids differ from the plain version")
    check(torch.allclose(ver_v, ver_plain[0], rtol=1e-5, atol=1e-5),
          f"verify_topk: d² max |diff| {ver_err}")
    del ver_plain
    # each distinct candidate row read once: the batch is one group of queries
    uniq = int(torch.unique(cand[cand >= 0]).numel())
    check(kver.group_size(64, impl.d) == 64 and int(rows_read) == uniq,
          f"verify_topk: the distance pass read {int(rows_read)} rows for {uniq} distinct ids")
    n_edge = edge_parity(torch, dev, ref, ops, kpair, ksel, kver, ktopk, kproj)
    emit({"phase": "parity", "edge_cases": n_edge, "kernels": {
        "pairwise_sq_dist": {"shape": [64, impl.n, impl.m], "max_abs_err": pw_err,
                             "tol": pw_tol},
        "radius_select": {"shape": [64, impl.n], "T": T, "T_pad": T_pad,
                          "identical": sel_same, "max_abs_err": sel_err,
                          "count_min": int(sel[2].min()), "count_max": int(sel[2].max())},
        "verify_topk": {"shape": [64, T, impl.d], "k": K, "ids_identical": ver_ids_same,
                        "max_abs_err": ver_err, "rows_read": int(rows_read),
                        "unique_rows": uniq}}})

    # -- the fused main path -------------------------------------------------
    counts.reset()
    answers, pairwise_at = {}, {}
    for B in BATCHES:  # in turns: each B's own pairwise launches
        before = counts.LAUNCHES["pairwise_sq_dist"]
        answers[B] = index.search(queries[:B], K)
        pairwise_at[B] = counts.LAUNCHES["pairwise_sq_dist"] - before
    fused_counts = counts.snapshot()
    for name in ("pairwise_sq_dist", "radius_select", "verify_topk"):
        check(fused_counts["launches"][name] > 0, f"fused path never launched {name}")
    check(fused_counts["routes"]["radius_select.overflow"] == 0,
          "fused path rerouted a select to the sort")
    for B in BATCHES:
        ids_plain = ann_query(impl, torch.from_numpy(queries[:B]).to(dev), k=K, T=T,
                              fused=True, force="plain")[0].cpu().numpy()
        check(np.array_equal(answers[B].indices, ids_plain),
              f"fused path at B={B}: kernel ids differ from the plain path's")
    exact = exact_knn(torch, impl.data, q64, K)
    got = answers[64].indices
    recall = float(np.mean([len(set(got[i]) & set(exact[i])) / K for i in range(64)]))
    check(recall > 0.5, f"recall@10 {recall} on the fused path")
    batch_ms = {}
    for B in BATCHES:
        qB = queries[:B]
        batch_ms[B] = time_ms(torch, lambda: index.search(qB, K), reps=7, warmup=1)
    emit({"phase": "fused", "launches": fused_counts["launches"],
          "routes": fused_counts["routes"], "ids_identical_to_plain": True,
          "recall_at_10": recall, "queries_for_recall": 64,
          "candidates_selected_b64": answers[64].stats.candidates_selected,
          "median_batch_ms": {str(B): batch_ms[B] for B in BATCHES},
          "queries_per_s": {str(B): B / batch_ms[B] * 1e3 for B in BATCHES}})
    profiles(torch, "profile", lambda B: index.search(queries[:B], K), batch_ms)

    # -- the unfused path (n < 8192) ----------------------------------------
    small = make_clustered_twin(4096, DIM, seed + 2)
    q_small = make_queries(small, 16, seed + 3)
    index_s = build_index(small, IndexConfig(backend="flat", seed=seed), device=dev)
    T_s = candidate_budget(index_s.impl.params, index_s.n, K)
    counts.reset()
    res_s = index_s.search(q_small, K)
    unfused_counts = counts.snapshot()
    for name in ("pairwise_sq_dist", "pairwise_sq_dist_rows"):
        check(unfused_counts["launches"][name] > 0, f"unfused path never launched {name}")
    qs = torch.from_numpy(q_small).to(dev)
    ids_plain = ann_query(index_s.impl, qs, k=K, T=T_s, fused=False,
                          force="plain")[0].cpu().numpy()
    check(np.array_equal(res_s.indices, ids_plain),
          "unfused path: kernel ids differ from the plain path's")
    _, cand_s = ref.topk_smallest(
        ref.pairwise_sq_dist(index_s.impl.family.project(qs), index_s.impl.projected), T_s)
    rows = index_s.impl.data[cand_s.to(torch.int64)]
    rows_k = kpair.pairwise_sq_dist_rows(qs, rows)
    rows_err = float((rows_k - ref.pairwise_sq_dist(qs, rows)).abs().max())
    check(torch.allclose(rows_k, ref.pairwise_sq_dist(qs, rows), rtol=1e-5, atol=1e-5),
          f"pairwise_sq_dist_rows: max |diff| {rows_err}")
    emit({"phase": "unfused", "n": index_s.n, "B": 16, "T": T_s,
          "launches": unfused_counts["launches"], "ids_identical_to_plain": True,
          "rows_max_abs_err": rows_err})

    # -- the quantized path and closest pair ----------------------------------
    adc = quant_phase(torch, dev, data, queries, exact, seed)
    join = cp_phase(torch, dev, seed)

    # -- the streaming index, and the fused projection ------------------------
    stream = stream_phase(torch, dev, data, queries, seed)
    audio, exact_pairs = join.pop("audio"), join.pop("exact")
    pq_index, cp_index = adc.pop("index"), join.pop("index")
    pq_recall = adc.pop("recall")
    stream_cp_phase(torch, dev, audio, exact_pairs, seed)
    proj = project_phase(torch, dev, impl.data, q64, seed)

    # -- per-kernel times at the main path's shapes (B = 64) ------------------
    B, n, d = 64, impl.n, impl.d
    x_proj = impl.projected
    entries = []

    def entry(name, path, source, replaces, launches, err, fn, plain, library,
              bytes_moved, ops_count, plain_ms=None):
        t_bound, by = bound(bytes_moved, ops_count)
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": launches, "max_abs_err": err,
            "ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn),
            "plain_ms": plain_ms if plain_ms is not None else time_ms(torch, plain, reps=3,
                                                                     warmup=1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": None if library is None else time_ms(torch, library, reps=3,
                                                               warmup=1)})

    csrc = "src/repro_torch/kernels/csrc/"

    def pairwise_entry(path, launches, qq, xx):
        """pairwise_sq_dist at one shape, held against its plain version
        (the norm trick's cancellation scales with |q|² + |x|²)."""
        Bq, dq, Nx = qq.shape[0], qq.shape[1], xx.shape[0]
        err = float((kpair.pairwise_sq_dist(qq, xx) - ref.pairwise_sq_dist(qq, xx)).abs().max())
        tol = 1e-5 * float((qq * qq).sum(1).max() + (xx * xx).sum(1).max())
        check(err <= tol, f"pairwise_sq_dist {(Bq, Nx, dq)}: max |diff| {err} > {tol}")
        entry("pairwise_sq_dist", path, csrc + "pairwise_dist.cu",
              "src/repro/kernels/pairwise_dist.py:28", launches, err,
              lambda: kpair.pairwise_sq_dist(qq, xx), lambda: ref.pairwise_sq_dist(qq, xx),
              lambda: torch.cdist(qq, xx) ** 2,
              4 * (Bq * dq + Nx * dq + Bq * Nx), 2 * Bq * Nx * dq + 2 * Bq * Nx)
        entries[-1]["shape"] = [Bq, Nx, dq]

    for Bq in BATCHES:  # the float path's estimate at each batch size
        pairwise_entry("fused", pairwise_at[Bq], qp[:Bq].contiguous(), x_proj)
    L, iters = 16, 14
    entry("radius_select", "fused", csrc + "select.cu",
          "src/repro/kernels/select.py:55",
          fused_counts["launches"]["radius_select"], sel_err,
          lambda: ksel.radius_select(d2p, tau0, T),
          lambda: ref.radius_select_exact(d2p, tau0, T),
          lambda: torch.topk(d2p, T, largest=False),
          4 * B * n + 4 * B + 8 * B * T + 4 * B, (L + iters + 2) * B * n)
    entry("verify_topk", "fused", csrc + "verify.cu",
          "src/repro/kernels/verify.py:34",
          fused_counts["launches"]["verify_topk"], ver_err,
          lambda: kver.verify_topk(impl.data, q64, cand, K),
          lambda: ref.verify_topk(impl.data, q64, cand, K),
          lambda: torch.topk(((impl.data[cand.to(torch.int64)] - q64[:, None, :]) ** 2)
                             .sum(-1), K, largest=False),
          4 * (uniq * d + B * d + B * T) + 8 * B * K, 3 * B * T * d)
    Bs, Ts = rows.shape[0], rows.shape[1]
    entry("pairwise_sq_dist_rows", "unfused", csrc + "pairwise_dist.cu",
          "src/repro/kernels/pairwise_dist.py:28",
          unfused_counts["launches"]["pairwise_sq_dist_rows"], rows_err,
          lambda: kpair.pairwise_sq_dist_rows(qs, rows),
          lambda: ref.pairwise_sq_dist(qs, rows),
          lambda: torch.cdist(qs[:, None, :], rows).squeeze(1) ** 2,
          4 * (Bs * d + Bs * Ts * d + Bs * Ts), 3 * Bs * Ts * d)
    entry("adc_dist", "quant", csrc + "adc.cu", "src/repro/kernels/adc.py:36",
          adc["launches"], adc["err"], adc["fn"], adc["plain"], adc["library"],
          adc["bytes"], adc["ops"])
    entry("pair_join", "cp", csrc + "pair_join.cu", "src/repro/kernels/pair_join.py:61",
          join["launches"], join["err"], join["fn"], None, None, join["bytes"],
          join["ops"], plain_ms=join["plain_ms"])
    d2_delta = stream["d2"]
    Bt, Nt = d2_delta.shape
    tv, ti = ktopk.topk_smallest(d2_delta, K)
    pv, pi = ref.topk_smallest(d2_delta, K)
    # tolerance: exact (pure selection; the values are copies)
    check(torch.equal(ti, pi) and torch.equal(tv, pv),
          "topk_smallest: values or indices differ from the plain version")
    # the topk kernel at verify's shape: the d² of the B = 64 candidates in
    # the select's index order, as verify hands them to it
    d2_ver = torch.stack([((impl.data[c.long()] - qb) ** 2).sum(-1) for c, qb in zip(cand, q64)])
    tv, ti = ktopk.topk_smallest(d2_ver, K)
    pv, pi = ref.topk_smallest(d2_ver, K)
    check(torch.equal(ti, pi) and torch.equal(tv, pv),
          "topk_smallest at verify's shape: values or indices differ from the plain version")
    topk_at_verify = {"shape": list(d2_ver.shape), "k": K,
                      "ms": time_ms(torch, lambda: ktopk.topk_smallest(d2_ver, K)),
                      "device_ms": device_ms(torch, lambda: ktopk.topk_smallest(d2_ver, K)),
                      "plain_ms": time_ms(torch, lambda: ref.topk_smallest(d2_ver, K), reps=3,
                                          warmup=1),
                      "bound_ms": bound(4 * d2_ver.numel() + 8 * 64 * K, d2_ver.numel())[0],
                      "library_ms": time_ms(torch, lambda: torch.topk(d2_ver, K, largest=False),
                                            reps=3, warmup=1)}
    del d2_ver
    entry("topk_smallest", "stream", csrc + "topk.cu", "src/repro/kernels/topk.py:27",
          stream["launches"], float((tv - pv).abs().max()),
          lambda: ktopk.topk_smallest(d2_delta, K),
          lambda: ref.topk_smallest(d2_delta, K),
          lambda: torch.topk(d2_delta, K, largest=False),
          4 * Bt * Nt + 8 * Bt * K, Bt * Nt)
    pairwise_entry("stream", stream["delta_scans"], stream["q"], stream["x_delta"])
    entry("project_dist", "project", csrc + "project_dist.cu",
          "src/repro/kernels/project_dist.py:30", proj["launches"], proj["err"],
          proj["fn"], proj["plain"], proj["library"], proj["bytes"], proj["ops"])
    # the select's launches: a memset, the ladder, a histogram pass per 7
    # bisection steps, the compaction; each reads d once but the memset
    sel_launches = launch_ms(torch, lambda: ksel.radius_select(d2p, tau0, T),
                             ("select_", "emset"))
    labels = {"select_ladder": "ladder", "select_pass": "pass", "select_compact": "compact"}
    sel_passes = {}
    for name, ms in sel_launches:
        label = next((v for k, v in labels.items() if k in name), "memset")
        if label == "pass":
            label = f"pass_{sum(key.startswith('pass') for key in sel_passes)}"
        sel_passes[label] = ms
    kernels_run = [k for k in sel_passes if k != "memset"]
    check(kernels_run == ["ladder", "pass_0", "pass_1", "compact"],
          f"radius_select launched {[n for n, _ in sel_launches]}")
    d_reads = len(kernels_run)
    # verify's launches: a memset, the count, three scan kernels, the
    # scatter, the distance pass, the topk kernel's split and merge
    ver_launches = launch_ms(torch, lambda: kver.verify_topk(impl.data, q64, cand, K),
                             ("verify_", "topk_kernel", "emset"))
    ver_labels = (("verify_entries_kernel<false>", "count"), ("verify_entries_kernel<true>", "scatter"),
                  ("tile_sum", "scan_tiles"), ("tile_scan", "scan_sums"),
                  ("tile_write", "scan_write"), ("verify_dist", "distance"),
                  ("topk_kernel<false, false>", "topk_splits"),
                  ("topk_kernel<true, true>", "topk_merge"),
                  ("topk_kernel<false, true>", "topk_one"))
    ver_parts = {}
    for name, ms in ver_launches:
        label = next((v for k_, v in ver_labels if k_ in name), "memset")
        ver_parts[label] = ver_parts.get(label, 0.0) + ms
    check({"count", "scatter", "distance"} <= set(ver_parts),
          f"verify_topk launched {[n for n, _ in ver_launches]}")
    E = int((cand >= 0).sum())
    # the algorithm's own traffic (repro/obs/roofline.py's models), beside
    # the one-read bounds above, and what verify's bound counts
    extra = {
        "radius_select": {"traffic_model_ms": (d_reads * B * n * 4 + 2 * B * T * 4)
                          / PEAK_BYTES_PER_S * 1e3,
                          "d_reads": d_reads, "launch_device_ms": sel_passes},
        "verify_topk": {"traffic_model_ms": verify_traffic_bytes(n, d, B, T, K, uniq, E)
                        / PEAK_BYTES_PER_S * 1e3,
                        "candidate_reads": B * T, "unique_rows": uniq,
                        "rows_read": int(rows_read), "launch_device_ms": ver_parts},
        "topk_smallest": {"at_verify_shape": topk_at_verify},
        "pair_join": join["extra"]}
    for e in entries:
        e.update(extra.get(e["name"], {}))
    emit({"kernels": entries})

    # -- kernel spans on the roofline, and the quality auditor ------------
    obs_trace_phase(torch, dev, {"fused": lambda: index.search(queries, K),
                                 "flat-pq": lambda: pq_index.search(queries, K),
                                 "cp": lambda: cp_index.cp_search(K)}, entries)
    del pq_index, cp_index
    quality_phase(torch, index, queries, answers[64], recall)

    # -- the paper's own index, its range query, the baselines, the stream --
    # (after the kernels line, whose traces they would otherwise precede)
    pm = pmtree_phase(torch, dev, audio, exact_pairs, seed)
    pmtree_range_phase(torch, dev, pm["index"], audio, seed)
    baselines_phase(torch, dev, audio, seed)
    stream_pmtree_phase(torch, dev, audio, seed)
    stream_backends_phase(torch, dev, data, audio, seed)

    # -- the serving front end over the Deep1M twin -----------------------------
    serve_phase(torch, dev, data, seed)

    # -- the sharded backends over an emulated mesh and an NCCL group --------
    sharded_phase(torch, dev, data, queries, exact, index, recall, pq_recall, audio, seed)

    # -- the durable stream: WAL, snapshots, two crashes, recover() -----------
    durable_phase(torch, dev, data, queries, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = nvidia_smi()

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, ROOT),
          "sources": sorted(p.name for p in _build.CSRC.glob("*.cu"))})

    index_phases(torch, dev, args.seed)
    # the index phases' tensors are gone with their frame
    gc.collect()
    torch.cuda.empty_cache()

    # -- the entry points' twins on the index side ---------------------------
    entry_points_phase(torch, dev)
    # the LM starts on a card holding nothing but the kernels
    gc.collect()
    torch.cuda.empty_cache()

    # -- the LM examples' twins: own sizes, against the CPU, yi-6b's width -----
    lm_examples_phase(torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- yi-6b served at full width, then its hidden states as a datastore -----
    lm = lm_serve_phase(torch, dev, args.seed)
    dry_cells = dryrun_serve_cells(torch, dev, lm)
    lm_knn_phase(torch, dev, lm, args.seed)
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    # -- the hybrid, ssm and encdec families at their published widths -------
    lm_families_phase(torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the LM's data axis: the sharded decode, data-parallel training -------
    long_case = lm_shard_phase(torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lm_dp_train_phase(torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the LM's ('data', 'model') mesh ------------------------------------------
    lm_tp_phase(torch, dev, long_case, args.seed)
    del long_case
    gc.collect()
    torch.cuda.empty_cache()

    # -- yi-6b trained at its published widths, then the training checks ------
    dry_cells.append(lm_train_phase(torch, dev, args.seed))

    # -- the dry run held to the card, and one production cell ------------------
    dryrun_phase(torch, dry_cells)

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
