#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # phases 0-14, 16-19 and 25, on card 0
    python3 chip_smoke.py --cards 4    # phases 0, 1, 15, 20-24 and 26, on 4 cards

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(with ``nvcc``, into the package's ignored ``build/`` directory), holds each
kernel against its plain PyTorch version at the main path's shapes, then
drives the main path through the entry points a user calls, at the size of
the paper's covtype dataset (N = 581,012, d = 54, K = 7; synthetic content
from a seed):

  phase 0  card and library versions
  phase 1  kernel build; rb_binning's hot loop in SASS (cuobjdump) must hold
           no MUFU, FRND or F2I instruction
  phase 2  every kernel against its plain version, with times and bounds:
           bin_counts exactly (and equal to the CSC's column lengths, to the
           sum of the streaming fit's five chunks, on two streams, and on a
           planted pattern of every row in one bin a grid), with the
           pattern's skew (the hottest bin's share of a grid's rows);
           rb_binning bit for bit on all rows and on planted rows whose
           quotient sits on or one ulp off an integer; z_matmul's strip
           kernel bit-equal to its gather kernel, with its strip, idx and
           shared-memory traffic; the gather kernel on its own row at the
           serving engine's top bucket (4,096 rows, K = 7, phase 12's
           shape), and at each bucket (64 to 4,096 rows) for K = 1 (the
           degrees) and K = 7 (the projection), the bits of the in-order
           fold over the grids, timed beside embedding_bag and its bound
           (the V rows the batch references), and its launch floor (one
           row, one grid); zt's L2 gather volume; the fused Gram
           kernel bit-equal to zt_matmul then z_matmul, timed beside that
           composition; kmeans_assign and its statistics form (counts
           equal to bincount's, the same bits twice) timed on the device
           alone (launches queued behind a spin kernel), with the host's
           dispatch per call beside them
  phase 3  SCRBModel.fit on the card; every kernel's launch count > 0,
           every z product of the fit through the strip kernel and every
           Gram product through the fused kernel; LOBPCG's iterations
           equal to zt then z's (FIT_ITERATIONS); the kmeans stage split
           into k-means++ seeding and Lloyd steps, by the same calls on the
           fitted embedding (which must give the fit's labels)
  phase 4  save → load → predict (requests of 64, 1,000, 4,096 rows and a
           100,000-row batch); predict agrees with the fit labels ≥ 0.99
  phase 5  two fits of a 65,536-row slice give identical labels
  phase 6  the flash-attention kernel against its plain version, at the LM
           prefill's shape (B 4, S = T = 4,096, H 16, Hkv 8, hd 128, bf16,
           causal) and at small shapes (f32 and bf16; causal, windowed,
           non-causal; ragged S; S != T; grouped K/V), with times and
           bounds, and at stablelm-12b's head dim 160 (B 1, S = T = 4,096,
           H 32, Hkv 8) beside SDPA; planted faults (causal mask off by
           one, the diagonal 64-key tile dropped, K/V heads mapped h % Hkv)
           must fail the check
  phase 7  LM serving of internlm2-1.8b at full width and depth (24 layers,
           d 2,048, bf16, weights drawn on the card from --seed): 4
           requests of 4,096 prompt tokens, 32 new tokens each, greedy then
           at temperature 0.8; one flash launch per layer per generate;
           every layer's kernel output within the bf16 row limit of the
           plain version on the same inputs (the planted faults fail it);
           prefill logits through the kernel no further from a float32
           truth than twice the plain bf16 attention's; two greedy runs
           give the same tokens
  phase 8  the host-chunked (streaming) fit, SCRBModel.fit with chunk_size
           131,072 (four full chunks and a ragged one of 56,724 rows): x and
           every O(N) array on the host, one chunk at a time on the card.
           Its k-means is the reference's host-chunked one (mini-batch
           streaming_kmeans, max(kmeans_iters, chunks) steps): its labels
           agree ≥ 0.99 with that k-means run on the card, from the same
           generator, over phase 3's device-resident embedding cut into the
           same chunks; the agreement with phase 3's Lloyd labels is
           printed (the data has no cluster gap, and the two k-means settle
           apart). The LOBPCG solve stops before its iteration cap at both
           N (at N/2 at a residual of 1e-2: that fit is held by its
           memory alone), the leading K Ritz values within 1e-3
           relative of phase 3's and the embedding's span within
           principal-angle cosines ≥ 1 − 1e-3; one bin_counts launch per
           chunk, every other kernel of the path launched, no fused Gram
           product; the degrees the same bits at chunks of 131,072 and
           100,000 rows;
           stage seconds, LOBPCG iterations, the Gram sweeps' H2D bytes and
           GB/s and their share of the svd stage; peak device memory, which
           must stay within 64 MiB at N = 290,506 (the first half of the
           rows, same chunk); save → load → predict of the chunked model on
           4,096 rows agrees with its fit labels ≥ 0.99
  phase 9  every other solver on the covtype-shaped data, one device fit
           each (lobpcg_host, randomized, auto, lanczos, subspace), held
           against a LOBPCG fit of the same rows: for a converged solve
           (tol reached, or auto's stability stop) Ritz values within 1e-3
           relative, the sine of the largest principal angle of the
           leading K vectors ≤ 1e-2 and labels by ARI ≥ 0.99 (LOBPCG from
           another start block printed beside them); otherwise a
           Rayleigh–Ritz lower bound; iterations and svd s. A fit with
           SCRBConfig(trace=...) beside an untraced one: the Chrome trace
           parses and holds fit, the five stages and eigensolve, and
           diagnostics["memory"] holds device numbers. The device's busy
           share over one fit from torch.profiler. The host-chunked
           randomized and auto on the first 131,072 rows (two chunks)
  phase 10 the compressive cell on poker-shaped data (paper Table 1: N =
           1,025,010, d = 10, K = 10, R = 256; not cut). First the kernels
           at the compressive cell's widths: the Gram product bit-equal to
           zt then z and within the sum tolerance of its plain version at
           K = 1, 14 and 32, zt and z at d = 14, kmeans_assign and its
           statistics form exact at d = 14, K = 10, with times and bounds.
           Then SCRBModel.fit(solver="auto") must route to compressive on
           the card (its kernels launched); a second fit gives the same
           labels; predict on the training rows gives the fit's labels
           ≥ 0.999. A LOBPCG solve of the same data gives θ_K and θ_K+1:
           the cold cutoff and its labels' ARI are printed beside them,
           with the eigencount at θ_K and the share the null space adds
           (not gated: the reference's estimator, ROADMAP.md C5). The cell
           with that bracket (CompressiveOptions.lambdas) must agree with
           LOBPCG's labels by ARI ≥ 0.99 and predict its own ≥ 0.999;
           solver="auto" with chunk_size=131,072 must route to the
           host-chunked cell (no fused Gram launch); the bracketed cell on
           host chunks must agree with the device one by ARI ≥ 0.99, and
           its peak device memory stay within 64 MiB from N/2 to N
  phase 11 the paper's comparison methods (baselines.METHODS, Table 2) on
           phase 3's covtype-shaped data, rank 256: every method on the
           card (sc on the first 8,192 rows: its W is N × N), with fit
           seconds by stage, accuracy and ARI against the planted labels
           and peak device memory. Each dense map's transform of 65,536
           rows within 1e-5 of the same fitted map on the CPU (an LSC row
           whose kept anchors differ must sit on a near-tie); SCRBModel
           fits of sc_rf, sv_rf, sc_nys and sc_lsc predict their fit
           labels ≥ 0.99 on the training rows and save → load → predict
           the same bits; two runs of each method on 65,536 rows give the
           same labels; a host-chunked sc_rf fit (chunks of 131,072 on the
           first 262,144 rows) agrees ≥ 0.99 by ARI with the same
           streaming k-means over the device sc_rf fit's embedding in the
           same chunks (its ARI against the device fit's Lloyd labels is
           printed)
  phase 12 the serving engine (ClusterEngine on CUDA graphs) with phase 3's
           RB model and phase 11's sc_nys model, buckets 64 to 4,096: after
           warmup one graph per (model, bucket, mode); two waves of 160
           requests of 1–5,000 rows in both modes, every answer bit-
           identical to model.predict/transform; no capture, no staging
           buffer and no device allocation in the second wave; the RB
           path's kernels replayed; the LRU leg (max_resident_models=1)
           bit-identical with no new capture; every kernel the graphs
           replayed has a row in the kernels line; an HTTP round trip through
           ClusterServer on 127.0.0.1. Rows/s against per-request
           model.predict, p50/p99 latency per bucket, a 64-row cell's
           graph replay against the same launches issued eagerly, and at
           each bucket the RB predict replay's host and device µs beside
           the device µs of each kernel in it (torch.profiler: rb_binning,
           the two gathers, kmeans_assign) and the bucket's gather launches

  phase 13 the partitioned fit (placement="partitioned", 4 partitions of
           145,253 rows) at covtype's N: one worker, then a worker a
           partition each on a CUDA stream of its own; labels and merged
           singular values bit-identical between the two, their launch
           counts equal to each other and to the sub-fits run one by one
           plus a zt a partition (the merge) plus the labelling pass;
           predict on the training rows the fit labels at 1.000000; save →
           load → predict the same bits; the engine at one bucket equal to
           model.predict; the card against the CPU on 24,000 rows (k-means++
           drawn on the CPU for both) by ARI ≥ 0.99; a host-chunked
           partitioned fit on the first 65,536 rows (2 partitions, chunks
           of 16,384). Printed, not gated: stage seconds at each worker
           count, the 4-worker fit's device idle share (phase 9's
           profiler method), ARI against phase 3 and accuracy
  phase 14 the mesh placement (SCRBModel.fit(..., mesh=...)) at covtype's
           N: a spawned gloo world of 2 ranks sharing the card (290,506
           rows a shard) fits fp32 twice, with a bf16 all_reduce payload and
           with chunks of 131,072 rows within the shards; each shard's ELL
           indices and the all_reduced (D,) counts equal to the single
           card's bit for bit; one Gram product (local zt, all_reduce,
           local z) within 1e-5 relative of the fused single-card product;
           every fit's Ritz values within 1e-4 of phase 3's and its
           embedding's span within a principal-angle sine of 1e-2; the
           ranks' labels equal, a repeat fit's too, and ARI ≥ 0.99 against
           the mesh's k-means run in one process over the same embedding;
           predict(mesh=) equal to a one-process predict (the bf16 fit:
           Ritz values within 2^-8, the payload's rounding, and its span
           printed). Then a spawned NCCL world of 1: the Ritz and span
           gates, and its labels against the gloo world's by ARI ≥ 0.99.
           Printed: fit seconds, iterations, the all_reduce ms of the (D,
           K) payload (two ranks on one card: not a scaling figure), ARI
           against phase 3's labels (not gated: the mesh's k-means seeds
           from a pool of 64 rows, and on data with no cluster gap k-means
           settles by its seeds). The bf16 fit runs 100 iterations (its
           residuals stall above tol). Then one mesh fit of each other
           solver (lanczos, randomized, auto, compressive; subspace's
           mesh fit is phase 15's, on NCCL) in the gloo world, each held
           to the same solver's single fit on the card
           (phase 9's, and for compressive a fit with LOBPCG's bracket
           CompressiveOptions.lambdas, the same options for both): Ritz
           values within 1e-3 relative, the same iteration count on both
           ranks, labels ARI ≥ 0.99 against the same k-means (or, for
           compressive, the same subset k-means) run in one process over
           the same embedding; the embedding's sine to the single fit's,
           wall and svd seconds, Gram products and the all_gather ms of a
           global mat-vec printed
  phase 15 only with --cards N (N = 2 or 4; fails unless N cards are
           present; phases 2-14 do not run): (a) each library's entry
           points on cuda:0, then on every other card in the same process,
           against the plain version and bit-equal to card 0's output (the
           kernels' launch setup is per device); (b) the mesh over NCCL,
           one rank a card, at 1, 2 and N ranks against a single fit on
           cuda:0 in this process: Ritz values within 1e-5, counts and
           degrees bit-equal, labels ARI ≥ 0.99 against the same k-means in
           one process, iteration counts equal on every rank; at N ranks
           also chunks of 131,072 within the shards, the bf16 payload
           (Ritz within 2^-8), every other solver as in phase 14 and
           predict(mesh=) (≥ 0.99 against the fit, equal to predict());
           the all_reduce ms of the (D, K) payload beside a ring
           all-reduce's bound over NVLink; (c) the partitioned fit with
           device="cuda" (partition i on card i mod N) at one worker and a
           worker a card, bit-identical to each other and to the same fit
           on cuda:0 alone, predict at 1.000000, save/load and the engine
           bit-identical, and each card's idle share; (d) every card's name
           and power limit and `nvidia-smi topo -m`
  phase 16 the DeepSeek models, one after the other (the card freed
           between them), at full width, bf16, weights drawn on the card
           from --seed: deepseek-v2-lite-16b (27 layers: MLA, the MoE FFN)
           and deepseek-moe-16b (28 layers: GQA through the flash kernel,
           the MoE FFN). Each: the parameter count equal to the config's;
           a layer-by-layer float32 check of one prefill of 4 x 4,096
           tokens (each layer's mixer and FFN output against a float32
           version written out apart from the port, on the same input, one
           layer's weights upcast at a time: MLA with its keys and values
           decompressed per head, the MoE by a loop over experts at the
           bf16 run's routing and capacity drops; rows within the bf16 row
           limit, MoE rows on the tokens whose float32 top-k set agrees,
           the disagreeing share printed) and, on deepseek-moe-16b, each
           layer's flash output against its plain version; planted faults
           (MLA scores without the rope term, MoE gates not renormalised)
           must fail the check; 32 new tokens each, greedy twice
           (identical tokens) and at temperature 0.8 twice (same seed,
           same tokens); prefill s, TTFT, decode ms/step beside the bound
           of reading every routed expert's weights, one decode step's
           device busy ms (torch.profiler) and one layer's mixer and FFN
           ms on the prefill's inputs, peak memory; flash launches per
           generate: 0 and 28 (one per GQA layer)
  phase 17 the last four architectures, one after the other (the card
           freed between them), at full width and depth, bf16, weights
           drawn on the card from --seed, served phase 7's requests:
           mamba2-370m (48 SSD layers), hymba-1.5b (32 hybrid layers:
           attention and an SSM on one input, 29 with a window of 1,024),
           qwen2-vl-7b (28 GQA layers, M-RoPE, embeds input) and
           musicgen-large (48 GQA layers, H = Hkv = 32, embeds input); the
           embeds models' prompts are (4, 4,096, D) drawn from the seed.
           Each: the parameter count equal to the config's (less the
           vocab x d embedding that param_count counts and an embeds model
           lacks); a layer-by-layer float32 check of one prefill written
           apart from the port (attention over every position with its
           own RoPE tables and the segment's window; each SSM mixer against
           a recurrence run one position at a time over the first 1,024
           positions, all 4,096 and the final state on the first SSM
           layer; Hymba's fused output; MLP rows; each flash output
           against its plain version), rows within the bf16 row limit;
           planted faults (the SSD scan not carrying its state between
           chunks, a windowed hybrid layer ignoring its window, M-RoPE's h
           and w sections swapped) must fail it; on qwen2-vl-7b a prefill
           with positions (3, 4, 4,096) laid out as an image of 32 x 32
           patches among text, its logits apart from plain RoPE's and the
           same bits twice; the flash kernel at the model's prefill shape
           beside SDPA (a boolean window mask for hymba), its plain
           version and its bound;
           greedy twice and at temperature 0.8 twice (same tokens), 4 new
           tokens each (NEW_ARCHS_NEW; phase 7's generates make 32); prefill
           s, TTFT, decode ms/step beside the bound of reading the weights
           once a step, one decode step's device busy ms, one layer's mixer
           and FFN ms, peak memory; flash launches per generate 0, 32, 28,
           48
  phase 18 LM training: internlm2-1.8b at full width and depth (24 layers,
           float32 masters drawn on the card from --seed, bf16 compute,
           remat "full"), Trainer over 10 steps of SyntheticTokens (4 x
           4,096 tokens, AdamW lr 3e-4, 2 warm-up steps): every step's
           loss, grad norm and flash launches (48: each layer's forward and
           its recompute in the backward), finite values and the last loss
           below the first; the median step of steps 3-10 beside its bound
           (6 x the parameters less the embedding x the tokens, plus the
           causal attention, at 989 TFLOP/s), tokens/s, peak memory, and
           one more step split into forward, backward and optimizer. A
           float32 check of one step at internlm2's width, 2 layers, 2 x
           1,024 tokens: the port's bf16 loss and every float32 master
           gradient against a float32 model written apart from the port
           (RMSNorm, RoPE, GQA with a full softmax, SwiGLU, full-vocab CE)
           by autograd, relative L2 a leaf within 5e-2; planted faults (the
           flash backward without its causal mask, dk and dv not summed
           over the GQA group, the CE's labels one position off) must fail
           it. AdamW on those gradients on the card against the CPU within
           1e-6. The flash Function alone at (4, 4,096, 16/8, 128) bf16:
           dq, dk, dv against autograd through the float32 plain version
           (rows within 1e-2), the plain backward's ms beside its bound
           (five causal products at 989 TFLOP/s) and SDPA's forward +
           backward ms. A restart at smoke size (bf16, remat "full"): 3
           steps, a checkpoint, 2 more; a fresh Trainer restores and
           repeats the 2 steps' losses
  phase 19 the LM on a mesh (models/sharding.py, the reference's FSDP×TP
           layout): a gloo world of 4 ranks sharing the card, mesh (data
           2, model 2), at internlm2-1.8b's width with 2 layers (bf16,
           remat "full", float32 masters drawn on the card from --seed by
           every rank, each keeping its shard): one sharded train step
           (launch.specs.build_cell's) against the unsharded step on the
           same card (the sharded init the same bits as one card's draws;
           the loss within 5e-3, every gradient leaf within 5e-2 and every
           updated master within 1e-2 relative L2; each leaf's update
           within 1e-5 of one card's AdamW on the step's own gathered
           gradients), 4 flash
           launches a step a rank (the attention on each rank's 8 of 16
           heads, 4 of 8 KV heads); greedy prefill + decode of 2 x 1,024
           tokens + 2 sharded against one card (tokens equal but at a
           near-tie of one card's top two logits, within twice the row's
           largest logit difference; each step's logits within 0.1
           relative L2); four planted faults of the step (a row-parallel
           exit reduced twice, a data rank's gradient share dropped, column
           shards on the wrong model rank, the vocab-parallel gold logit
           not summed) must each fail the check. The same world then runs
           deepseek-moe-16b's first 2 layers (dense, then MoE, its 64
           experts split over the model axis, 32 a rank) at full width:
           the same check, every MoE call's expert ids the same bits on
           the model ranks of a batch group, and two planted MoE faults
           (experts on the wrong model rank, routed partials not summed
           over the model axis) that must each fail it
  phase 20 only with --cards 4: stablelm-12b on an NCCL world of one rank
           a card, mesh (data 2, model 2): the 2-layer check of phase 19 at
           its width; greedy prefill + decode (2 x 1,024 tokens + 8) of the
           full model sharded against the one-card model (same gates); then 10 steps of
           Trainer at full width and depth (40 layers, 4 x 4,096 tokens of
           SyntheticTokens a step, AdamW lr 3e-4 after 2 warm-up steps,
           bf16 compute, remat "full"): a finite, falling loss, the same on
           every rank, 80 flash launches a step a rank; the median step of
           steps 3-10 (the slowest rank's) beside its bound (6 x the
           parameters less the embedding x the tokens plus the causal
           attention, at 4 x 989 TFLOP/s), tokens/s, each card's peak
           memory and the collectives' bytes a step; six planted faults
           (phase 19's four, the sequence parts gathered in the wrong order,
           the norms' gradients not summed over the model axis) must fail
           the 2-layer check
  phase 21 only with --cards 4: deepseek-moe-16b on the same mesh, its 64
           routed experts split over the model axis (expert parallelism,
           32 a card): the 2-layer check (layer 0 dense, layer 1 MoE, 4 x
           4,096 tokens, so the residual is split over the sequence) with
           the routing digests and the two MoE faults; greedy prefill +
           decode of the full model (2 x 1,024 + 8 tokens) sharded against
           the one-card bf16 model routed as the mesh routed (each MoE
           call of the prefill and of every decode step takes the mesh's
           expert ids; gates from its own probabilities there), and beside
           it the one card routing by its own router (printed: its logits'
           distance and the share of prompt tokens x layers routed to other
           experts; its first MoE layer's reroutes must be near-ties); then
           10 Trainer steps at full
           width and depth (28 layers, 4 x 4,096 tokens, the same settings
           as phase 20): a finite, falling loss, the same bits on every
           rank, 56 flash launches a step a rank, the median step beside
           its bound (6 x the active parameters, all but the embedding and
           58 of the 64 routed experts of each MoE layer, x the tokens
           plus the causal attention, at 4 x 989 TFLOP/s), tokens/s, each
           card's peak memory and the collectives a step by kind, beside
           why the same steps with the experts gathered whole have no time
           (MOE_BEFORE_WHY)
  phase 22 only with --cards 4: deepseek-v2-lite-16b on the same mesh, its
           MLA split over its 16 heads on the model axis (8 a card) and its
           experts as phase 21's: the 2-layer check (layer 0 MLA + dense
           MLP, layer 1 MLA + MoE, the residual split over the sequence)
           with two planted MLA faults (the heads' latent columns of w_uk
           and w_uv from the wrong model rank; w_dkv's and kv_ln's
           gradients not summed over the model axis); greedy serving held
           as phase 21's; 10 Trainer steps at full width and depth (27
           layers), 0 flash launches a rank (MLA's absorbed attention is
           plain PyTorch), the median step beside its bound, tokens/s,
           peak memory and collectives, printed beside the same steps with
           MLA gathered whole on every model rank (MLA_BEFORE)
  phase 23 only with --cards 4: qwen3-32b served on the same mesh (64
           heads, 8 KV heads, 32/4 a card; qk_norm), a prefill's residual
           split over the sequence and the embedding and head on their
           vocab shard (the logits split over the vocab on the model axis).
           The flash kernel at the prefill's local shape (B 2, S = T =
           4,096, H 32, Hkv 4, hd 128, bf16, causal) on card 0 against its
           plain version (rows within 1e-2), beside SDPA and its bound.
           The check: the first 32 layers at full width, greedy prefill +
           decode of 2 x 4,096 tokens + 8 sharded against the one-card
           model (the tokens and logits as phase 20's; every rank's tokens
           equal; each layer's K/V cache after the last step within 0.1
           relative L2 of one card's); three planted serving faults (the
           vocab shards' logits in the wrong model order, the last
           position from the wrong sequence part, a split prefill's caches
           written from the wrong sequence part) must each fail it. Then
           the full 64-layer model through Engine.generate, 4 x 4,096
           prompt tokens + 32 new: tokens equal on every rank, 64 flash
           launches a generate a rank, each layer's residual (2, 2,048,
           5,120) at the prefill; prefill s and prompt tokens/s beside
           the bound of 2 x the parameters less the embedding x the tokens
           plus the causal attention at 4 x 989 TFLOP/s, decode ms/step
           beside the weight-read bound, peak memory a card, each rank's
           collectives of the prefill and of one decode step by kind,
           printed beside the tree that gathered the tables whole and kept
           the residual whole (SERVE_BEFORE)
  phase 24 only with --cards 4: hymba-1.5b on (data 1, model 4), its 25
           query heads and 5 KV heads, which the model axis divides
           neither, dealt by sharding.head_ranges (10/5/5/5 query heads,
           2/1/1/1 KV heads; the K/V cache held by each rank's own KV
           heads), its 50 SSD heads by sharding.ssm_heads (13/13/12/12;
           the state and conv cache held by each rank's own heads), the
           two branches' partial outputs summed in one collective a layer.
           The flash kernel at the ranks' local shapes (B 4, S = T =
           4,096, 10/2 and 5/1 heads, hd 64, windowed at 1,024 and global)
           on card 0 against its plain version (rows within 1e-2), beside
           SDPA and its bound. The 2-layer check (layer 0 global, layer 1
           windowed): a training step on 4 x 4,096 tokens held as phase
           20's, with four planted faults (query heads reading the KV head
           one group over; KV head gradients from one model rank only; the
           SSM norm's squares not summed over the model axis; the SSM's B
           and C gradients from one model rank only); greedy prefill +
           decode of 2 x 4,096 + 8 tokens against one card (logits and
           tokens as phase 20's; every cache layer whole, K/V, SSM state
           and conv inputs, and the K/V's decoded rows alone within 0.1),
           with two planted decode faults (the new K/V, or the new SSM
           state, written into another head's slot). Then the full model
           through Engine.generate (4 x 4,096 + 32) and 10 Trainer steps,
           each printed beside the tree that ran the SSM whole
           (SSM_BEFORE)
  phase 25 the examples (examples_torch/) through main(argv) on the card
           at the JAX package's defaults, quickstart also at covtype's row
           count device-resident and streamed (100,000 rows in chunks of
           16,384), serve_lm also on internlm2-1.8b's smoke config
           (EXAMPLE_RUNS): each must launch its kernels (ops.LAUNCHES set
           to 0 before it, read after); quickstart's labels against the
           CPU's on the same RB grids and start block (ARI >= 0.99), its
           streamed labels against a device-resident fit of the same rows
           and grids (ARI >= 0.99); serve_predict's engine against
           model.predict bit for bit and its HTTP answer against the
           engine; embed_cluster's reloaded predict bit-identical;
           serve_lm's tokens in range and the same twice from one seed;
           embed_cluster (EXAMPLE_LM_STEPS pretraining steps) and
           serve_lm's prefill on the card against the same on the CPU
           from the same weights, the flash kernel at the examples' own
           shapes (float32, hd 32; S 31 in training, 32 pooled, 4/2 GQA
           heads at S 16 in the prefill): each step's loss within 1e-5
           relative, the pooled embeddings of the card's trained weights
           within 1e-5 of the largest entry, the prefill's logits within
           1e-4, and two planted flash faults (the causal mask off by
           one; kv heads mapped h % Hkv) must fail that check; then
           quickstart once as a command line at its defaults (exit 0;
           the other examples' command lines are tested on the CPU)
  phase 26 only with --cards 4: one eigensolver iteration of the
           clustering cell (core.distributed.make_gram_matvec: local zt,
           the all-reduce of the (D, K) block, local z) on an NCCL world of
           one rank a card, mesh (data 4), n = 6,250,000 (a data shard of
           the JAX package's production cell, 1,562,500 rows, a card), R
           256, d_g 4,096, K 16, idx uniform in each grid's bins from the
           seed: the collectives counted on the cards equal those of
           lower_clustering_cell on a fake world of the same mesh and n
           (run in a process of its own); every rank's y within the sum
           tolerance of the plain zt then z summed over the ranks (within
           1e-2 relative with the bfloat16 payload); a planted fault (q
           without the all-reduce) must fail that check; the iteration's
           median device ms of 10 in float32 and compressed, the zt and z
           products beside their bounds, the all-reduce beside its ring
           bound over NVLink

With ``--kmeans-baseline FILE`` phase 2 also builds FILE, a
``kmeans_assign.cu`` of another tree with the same ``kmeans_assign_launch``
entry point, holds its labels and distances against this tree's kernel and
times the two on the device alone, alternating (this, that, this, that).

Any failed check raises, and the script exits non-zero. It exits non-zero
before printing any result when no CUDA device is available or when the
package is not beside it. The last line is
``{"ok": true, "device": {...}}``; the line before it holds the card's name
and power limit, and the one before that the kernels' JSON record
(``launches``: per device-resident covtype fit, per host-chunked fit for
``bin_counts`` and ``z_matmul_gather`` (the gather route of its ragged last
chunk), per generate for the flash kernel; ``launches_compressive``:
per device compressive fit of phase 10; ``launches_engine``: launched by
the engine's graph replays in phase 12, which no wrapper counts;
``launches_partitioned``: per partitioned fit of phase 13;
``launches_mesh``: per mesh fit of phase 14, on one of its two ranks;
``launches_v2_lite`` and ``launches_moe_16b``: per generate of phase 16's
deepseek-v2-lite-16b and deepseek-moe-16b; ``launches_mamba2``,
``launches_hymba``, ``launches_qwen2_vl`` and ``launches_musicgen``: per
generate of phase 17's models; ``launches_train``: per training step of
phase 18; ``launches_lm_mesh``: per sharded train step of phase 19, on
one of its ranks; ``launches_examples``: over phase 25's runs of the
examples). With ``--cards 4`` no kernels line is printed; phases 20-24
print their flash launches a rank, phase 26 its zt and z launches.

Bounds: ``bound_ms`` is the larger of (bytes each input read once and each
output written once) / 3.35 TB/s and operations / the peak rate of their
type: 67 TFLOP/s for float32 (the SC_RB kernels), 989 TFLOP/s for bf16 on
the tensor cores (flash attention, counting the visible (q, k) pairs
only), the published H100 SXM peaks (dense, without sparsity, at 700 W).
The Gram product's bytes count the pattern twice (the CSC row ids and
idx): q = Zᵀu needs every row before any row of Z q can be formed, and
the pattern does not fit L2.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12

COVTYPE = ("covtype-mult", 7, 54, 581_012, "aniso")   # paper Table 1
N_GRIDS = 256
EIG_BLOCK = 11            # LOBPCG block width at K = 7 (K + buffer 4)
SERVE_REQUESTS = (64, 1_000, 4_096)
SERVE_BATCH_ROWS = 100_000
DETERMINISM_ROWS = 65_536
FIT_KERNELS = ("rb_binning", "z_matmul", "zt_matmul", "gram_matmul",
               "kmeans_assign", "kmeans_assign_stats")
# LOBPCG's iterations on this data with the Gram product as zt_matmul then
# z_matmul: the fused product gives the same bits, so the fit must stop
# where that composition's did
FIT_ITERATIONS = 31
# the host-chunked fit (phase 8): chunks of 131,072 rows (the z strip
# route's threshold, so the full chunks take it and the ragged last one the
# gather kernel); its peak device memory may grow by at most 64 MiB from
# the first half of the rows to all of them
STREAM_CHUNK = 131_072
STREAM_HALF = COVTYPE[3] // 2
# the N/2 fit is held to the N fit by its peak memory alone (set by the
# chunk buffers, not by the solve's depth): its LOBPCG stops at this
# residual (PR 29: at the fit's 1e-4, 63 iterations and 56 s of host
# algebra); the N fit keeps 1e-4 and every comparison with phase 3
STREAM_HALF_TOL = 1e-2
STREAM_FLAT_BYTES = 64 * 2**20
STREAM_KERNELS = ("rb_binning", "zt_matmul", "z_matmul", "z_matmul_gather",
                  "kmeans_assign", "kmeans_assign_stats")
STREAM_PREDICT_ROWS = 4_096
# phase 9: every other solver on the covtype-shaped data, device rows; the
# host-chunked randomized and auto on a row prefix, in two chunks
SOLVERS = ("lobpcg_host", "randomized", "auto", "lanczos", "subspace")
SOLVER_KERNELS = ("gram_matmul", "zt_matmul", "z_matmul")
RITZ_RTOL = 1e-3
SINE_MAX = 1e-2
# labels of a converged solver's fit against LOBPCG's: LOBPCG against
# itself from another start block gave ARI 0.9999, the converged solvers
# 0.9969-0.9998 in this phase (NVIDIA H100 80GB HBM3, 700 W)
SOLVER_ARI = 0.99
CHUNKED_SOLVERS = ("randomized", "auto")
CHUNKED_PREFIX = 131_072
CHUNKED_CHUNK = 65_536
TRACE_SPANS = ("fit", "rb_features", "degrees", "svd", "normalize", "kmeans",
               "eigensolve")
# phase 10: the compressive cell on poker-shaped data (paper Table 1),
# N >= CompressiveOptions.auto_n, so solver="auto" routes to compressive
POKER = ("poker", 10, 10, 1_025_010, "blobs")
COMPRESSIVE_KERNELS = ("rb_binning", "gram_matmul", "zt_matmul", "z_matmul",
                       "kmeans_assign", "kmeans_assign_stats")
GRAM_WIDTHS = (1, 14, 32)  # lanczos; d = ceil(4 log2(K+1)) at K = 10; probes
KMEANS_D, KMEANS_K = 14, 10
PREDICT_AGREE = 0.999
POKER_CHUNK = 131_072
# labels of the bracketed compressive cell against LOBPCG's, and of its
# host-chunked run against its device run: 0.9966 and 1.0000 in this
# phase (NVIDIA H100 80GB HBM3, 700 W)
COMPRESSIVE_ARI = 0.99
# phase 11: the Table-2 methods on phase 3's covtype-shaped data
BASELINE_RANK = 256
EXACT_SC_ROWS = 8_192        # sc's cut: its W is N × N
DENSE_ROWS = 65_536          # transform gate and determinism slice
DENSE_TOL = 1e-5             # tests/test_torch_cuda.py's card-vs-CPU limit
PREDICT_METHODS = (("sc_rf", "rff", True), ("sv_rf", "rff", False),
                   ("sc_nys", "nystrom", True), ("sc_lsc", "lsc", True))
BASELINE_CHUNK = 131_072
BASELINE_CHUNK_ROWS = 262_144   # the host-chunked sc_rf's cut
# phase 12: the serving engine
ENGINE_BUCKETS = (64, 256, 1_024, 4_096)
ENGINE_REQUESTS = 160        # requests a wave, 1–5,000 rows each
ENGINE_MAX_ROWS = 5_000
ENGINE_LATENCY_REPS = 50
ENGINE_KERNELS = ("rb_binning", "z_matmul_gather", "kmeans_assign")

LM_ARCH = "internlm2-1.8b"
LM_BATCH = 4               # requests served together (prefill_32k: 32)
LM_PROMPT = 4_096          # prompt tokens each (prefill_32k: 32,768)
LM_NEW = 32                # tokens generated each
# phase 17's generates (four a model: greedy twice, at a temperature
# twice) make NEW_ARCHS_NEW tokens each: their gates (equal tokens, the
# seed's tokens again, one flash launch a layer) need a few decode steps,
# and 31 steps a generate cost ~55 s of the one-card run (PR 29: 132.3 s)
NEW_ARCHS_NEW = 4
LM_CACHE = LM_PROMPT + LM_NEW
LM_TEMPERATURE = 0.8
# The bf16 prefill's logits are held against a float32 truth (the same
# weights in float32, plain float32 attention): the kernel path's relative
# L2 error may be at most LM_ERR_RATIO times the plain bf16 attention's.
# Both round P to bf16 once, at different places (unnormalised in the
# kernel, as the TPU kernel does; normalised in the plain version). This
# end check is coarse (a causal mask off by one can pass it); each layer's
# row check against the plain version is the one that tells a fault.
LM_ERR_RATIO = 2.0
FLASH_PATH = (LM_BATCH, LM_PROMPT, LM_PROMPT, 16, 8, 128)  # B S T H Hkv hd
FLASH_SMALL = [  # b, s, t, h, hkv, hd, causal, window
    (2, 128, 128, 3, 3, 32, True, None),
    (2, 256, 256, 3, 3, 64, True, 40),         # sliding window
    (2, 128, 128, 3, 3, 16, False, None),      # non-causal
    (1, 1000, 1000, 2, 2, 128, True, None),    # ragged S and T
    (1, 200, 333, 4, 2, 128, True, None),      # S < T, grouped K/V
    (1, 333, 200, 4, 2, 160, True, None),      # S > T, head dim 160
    (2, 300, 300, 4, 1, 160, False, 64),       # non-causal window
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 also holds each (b, s, h) row of hd outputs to a relative L2 error:
# the kernel and its plain version round P and the output to bf16 at other
# places, which costs a row ~3e-3 (at most 4.7e-3 for the TPU kernel in
# interpret mode, tests/test_torch_kernels.py); a key too many or too few
# moves a row over n keys by about 1/sqrt(n) (1.6e-2 at n = 4,096), a
# dropped tile by more.
FLASH_ROW_REL = 1e-2
FLASH_TILE = 64            # keys per tile of the bf16 kernel
# stablelm-12b's attention (configs/stablelm_12b.py: 32 heads, 8 KV heads,
# head dim 160) at one request of 4,096 tokens: timed beside SDPA
FLASH_HD160 = (1, 4_096, 4_096, 32, 8, 160)       # B S T H Hkv hd
# phase 13: the partitioned fit at covtype's N (145,253 rows a partition:
# each sub-fit on the strip route), one worker and then one a partition,
# each worker on a CUDA stream of its own
PART_N = 4
PART_WORKERS = (1, 4)
PART_KERNELS = ("rb_binning", "z_matmul", "zt_matmul", "gram_matmul",
                "kmeans_assign", "kmeans_assign_stats")
PART_CPU_ROWS = 24_000     # the card against the CPU, the same draws
# the host-chunked partitioned fit's prefix and chunks: two chunks a
# partition (PR 29: 131,072 rows in chunks of 32,768, 25.4 s)
PART_CHUNKED_ROWS = 65_536
PART_CHUNK = 16_384
PART_CHUNKED_N = 2
# chunks of 16,384 rows: every z product on the gather route
PART_CHUNKED_KERNELS = ("rb_binning", "bin_counts", "zt_matmul",
                        "z_matmul_gather", "kmeans_assign",
                        "kmeans_assign_stats")
PART_ARI = 0.99
PART_ENGINE_BUCKET = 4_096
# phase 14: the mesh placement, a gloo world of 2 ranks on the one card
# (290,506 rows a shard) and an NCCL world of 1
MESH_WORLD = 2
MESH_CHUNK = 131_072
MESH_KERNELS = ("rb_binning", "bin_counts", "zt_matmul", "z_matmul",
                "kmeans_assign", "kmeans_assign_stats")
MESH_GRAM_RTOL = 1e-5
MESH_RITZ_ATOL = 1e-4
# the bf16 payload rounds q by up to 2^-9 an entry: the operator moves by
# ‖E‖ ≲ 2^-8 (‖Â‖ ≤ 1), so its Ritz values may move that far (Weyl), and
# LOBPCG's residuals stall near that floor, above tol 1e-4
MESH_BF16_RITZ_ATOL = 2.0 ** -8
# so the bf16 fit runs to its iteration cap (PR 29: 300, 14.6 s on two
# gloo ranks); its gates (Ritz values, labels against the same k-means
# over its own embedding) hold long before: it runs this many
MESH_BF16_ITERS = 100
MESH_SINE = 1e-2
MESH_ARI = 0.99
MESH_PREDICT_ROWS = 20_000     # PR 29: 100,000
MESH_REDUCE_REPS = 5           # PR 29: 20
MESH_JOIN_S = 420.0
MESH_SOLVERS = ("lanczos", "subspace", "randomized", "auto", "compressive")
# phase 14's gloo world fits these; subspace (548 iterations, ~25 s of
# gloo all_reduces on one card) is held on the mesh by phase 15's NCCL
# worlds (--cards 4) at 1, 2 and 4 ranks
MESH_SOLVERS_GLOO = ("lanczos", "randomized", "auto", "compressive")
Z_STRIP_ROWS_15 = 131_072     # phase 15's kernel rows: the strip route's
MESH_GATHER_WIDTHS = (1, EIG_BLOCK)   # lanczos; the block solvers
MESH_NCCL_RITZ_ATOL = 1e-5
NVLINK_BYTES_PER_S = 450e9        # NVLink on an HGX H100, each way
CARDS_JOIN_S = 600.0
# phase 16: the DeepSeek models at full width (configs/deepseek_*.py),
# served the requests of phase 7 (LM_BATCH x LM_PROMPT tokens, LM_NEW new)
DS_ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
# each layer's bf16 mixer and FFN rows against float32 on the same input
# and weights: a row passes through ~9 bf16 roundings of its activations
# (each a relative error of at most 2^-9, ~1.1e-3 RMS), ~3.5e-3 together;
# a dropped rope term or unnormalised gates move a row by 1e-1 and more
DS_ROW_REL = FLASH_ROW_REL
DS_TRUTH_CHUNK = 256      # query rows a chunk in the float32 attention
# phase 17: the last four architectures at full width (configs/
# {mamba2_370m,hymba_1p5b,qwen2_vl_7b,musicgen_large}.py), served the
# requests of phase 7, each beside its key in the kernels line (flash
# launches per generate)
NEW_ARCHS = {"mamba2-370m": "launches_mamba2", "hymba-1.5b": "launches_hymba",
             "qwen2-vl-7b": "launches_qwen2_vl",
             "musicgen-large": "launches_musicgen"}
# qwen2-vl-7b and musicgen-large read (B, S, D) embeds drawn from the seed
# at a token embedding row's scale (the port's embedding init)
EMBED_STD = 0.02
# each SSM mixer's rows (mamba2's, hymba's SSM branch) and hymba's fused
# rows against a float32 recurrence run one position at a time over the
# first SSM_CHECK positions (the chunk boundaries at 256, 512 and 768
# inside), and over all LM_PROMPT positions of each model's first SSM
# layer; attention rows cover every position (hymba's window of 1,024
# matters only past the first 1,024)
SSM_CHECK = 1_024
# qwen2-vl-7b's M-RoPE prefill: MROPE_TEXT text positions, an image of
# MROPE_GRID x MROPE_GRID patches (t fixed, h the row, w the column), then
# text again from the image's largest position + 1 (Qwen2-VL's layout);
# its logits must move from the plain-RoPE prefill's by MROPE_MIN_REL
MROPE_TEXT = 1_000
MROPE_GRID = 32
MROPE_MIN_REL = 1e-3

# phase 18: LM training of internlm2-1.8b at full width and depth
TRAIN_ARCH = LM_ARCH
TRAIN_BATCH = 4
TRAIN_SEQ = 4_096          # 16,384 tokens a step
TRAIN_STEPS = 10
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
TRAIN_CHECK_LAYERS = 2     # the float32 check: full width, 2 layers,
TRAIN_CHECK_BATCH = (2, 1_024)  # on 2 x 1,024 tokens
# The check's limit on the loss and on every leaf's relative L2 error of
# the bf16 gradients (stated before the first run on the card): bf16
# operands round activations and gradients at 2^-9 relative each, through
# 2 layers and the loss.
TRAIN_GRAD_REL = 5e-2
TRAIN_OPT_TOL = 1e-6       # AdamW on the card against the CPU (float32)
TRAIN_RESTART_REL = 1e-6   # a restart's losses against the first run's

# phases 19 and 20: the LM on a (data, model) mesh. Phase 19: a gloo world
# of 4 ranks sharing card 0 at internlm2-1.8b's width with 2 layers; phase
# 20 (--cards 4): an NCCL world of one rank a card, stablelm-12b
MESH_LM_SHAPE = (2, 2)
MESH_LM_WORLD = 4
MESH_LM_BATCH = (4, 1_024)     # the 2-layer check's batch
MESH_LM_PROMPT = (2, 1_024)    # greedy prefill + decode
MESH_LM_NEW = 8
MESH_LM_NEW_GLOO = 2           # phase 19: each decode step gathers the
                               # embedding's and head's vocab shards over
                               # data through the host (gloo on one card)
MESH_LM_JOIN_S = 300.0
MESH_TRAIN_ARCH = "stablelm-12b"
MESH_TRAIN_JOIN_S = 900.0
# Limits, bf16 compute (NVIDIA H100 80GB HBM3, 700 W). The mesh sums each
# batch rank's bf16-rounded gradient in float32 (one card rounds the
# batch's once) and the row-parallel products' bf16 partials over the
# model axis, ~2^-9 relative an element, which the attention's key
# gradients amplify: the loss within MESH_LOSS_REL; each gradient leaf
# within MESH_GRAD_REL relative L2 (first stated as 2e-2; phase 19
# measured 1.65e-2 on a wk, and phase 18 puts one bf16 step's wq and wk
# gradients 2.27e-2 from float32, so two bf16 steps may differ by twice
# that: phase 18's own 5e-2). AdamW's first step is lr·sign(g) where
# |g| ≫ eps, so an entry whose gradient is below that noise may take the
# other sign: each updated master (|w| ≈ 0.02, an update ≈ lr = 1.5e-4)
# within MESH_MASTER_REL of the unsharded step's (a master drawn as zeros,
# hymba's SSM conv bias, is only its update after one step: printed; phase
# 24 measured 0.101 on it with every gradient leaf within 1.27e-2), and
# the sharded update
# within MESH_OWN_REL of one card's AdamW on the same gathered gradients
# (float32, the same operations; the global norm sums in another order).
# Serving rounds the row-parallel sums once, in float32; each step's
# logits within MESH_LOGIT_REL relative L2 of one card's (first stated as
# 5e-2; stablelm-12b's 40 layers measured 5.43e-2 at the first decode
# step, and phase 7 puts two bf16 paths of internlm2's 24 layers, the
# kernel's attention and the plain one, 3.40e-2 apart). A greedy token may
# part from one card's only where one card's top two logits are closer
# than twice that row's largest logit difference (a near-tie inside the
# measured noise); the row is not compared after it.
MESH_LOSS_REL = 5e-3
# phase 20 before the residual was split over the sequence and the
# embedding and loss over the vocab (four H100 80GB HBM3, 700 W each;
# PERF.md section 5): step s (median of steps 3-10), peak GiB a card,
# collective output a rank a step: {kind: (count, GB)}
MESH_BEFORE = {"step_s": (1.9187, 1.9382), "peak_gib": 51.88,
               "collectives": {"all-gather": (725, 25.314),
                               "all-reduce": (286, 16.778),
                               "reduce-scatter": (282, 13.170)}}
MESH_GRAD_REL = 5e-2
MESH_MASTER_REL = 1e-2
MESH_OWN_REL = 1e-5
MESH_LOGIT_REL = 0.1
# phase 21 (--cards 4): deepseek-moe-16b on the same mesh, its 64 routed
# experts split over the model axis; phase 19 also runs its first 2 layers
# (dense, MoE) with the MoE faults. Training at phase 20's 4 x 4,096 tokens
MOE_MESH_ARCH = "deepseek-moe-16b"
# phase 21's steps with the experts gathered whole and run on every model
# rank (the tree before the split, driven through this script's
# lm_mesh_rank on four H100 80GB HBM3 at 700 W; PERF.md section 5) have no
# step time to stand beside them, as MESH_BEFORE does phase 20's
MOE_BEFORE_WHY = ("out of memory in step 1's backward (the remat "
                  "recompute of an MoE layer, 76.49 GiB allocated on a "
                  "card of 79.18 GiB), so no step time")
# A token the mesh routes to other experts than one card's own router does
# (the 2-layer check's MoE calls; serving's first MoE layer, whose input
# the two runs form alike) must sit on a near-tie of one card's bf16 router
# logits: the logit of an expert one card picks and the mesh drops lies at
# most ROUTE_TIE_ULPS bf16 ulps (at the pair's larger logit) above that of
# an expert the mesh picks in its place. The mesh's training exits sum
# bf16 partials, so an element of the residual it forms may lie an ulp
# from one card's; through the RMSNorm and the router's 2,048-term sums
# (weights N(0, 0.006^2)) that moves a top-k logit by ~0.5 ulp rms, and
# the difference of a pair by ~0.7 ulp rms: 5 sigma over ~10^6 tokens x
# experts, plus each logit's bf16 rounding on both runs (half an ulp
# each), is ~5.5 ulps. (First stated as 4: phase 19 measured 6 on an
# H100.)
ROUTE_TIE_ULPS = 8
# phase 22 (--cards 4): deepseek-v2-lite-16b on the same mesh, its MLA split
# over its heads on the model axis and its experts as phase 21's
MLA_MESH_ARCH = "deepseek-v2-lite-16b"
# phase 22's steps with MLA gathered whole and run on every model rank (the
# tree before the split, driven through its own lm_mesh_rank in the call
# that timed this tree's, parent, change, change, parent; four H100 80GB
# HBM3 at 700 W; PERF.md section 5): as MESH_BEFORE
MLA_BEFORE = {"step_s": (3.1395, 3.1441), "peak_gib": 62.159,
              "collectives": {"all-gather": (1185, 37.990),
                              "all-reduce": (177, 0.007),
                              "reduce-scatter": (433, 17.021)}}
# phase 23 (--cards 4): qwen3-32b served on the same mesh, a prefill's
# residual split over the sequence, the embedding and head on their vocab
# shard. The check runs the first SERVE_CHECK_LAYERS of its 64 layers: the
# one-card model and the sharded one never share a card, so memory would
# take all 64 (~64 GiB on rank 0), but the bf16 noise against one card
# grows with depth, and MESH_LOGIT_REL was set at stablelm-12b's 40 layers
SERVE_MESH_ARCH = "qwen3-32b"
SERVE_CHECK_LAYERS = 32
SERVE_CHECK_PROMPT = (2, 4_096)     # S >= 2,048: the split is on
SERVE_CHECK_NEW = 8
SERVE_GENERATE = (4, 4_096, 32)     # full depth: batch, prompt, new tokens
# phase 23's full-depth generate on the tree that gathered the embedding and
# head whole and kept the residual whole (this script's lm_mesh_rank's
# generate part run with that tree's src first on sys.path, each tree in a
# process of its own, parent, change, change, parent, on four H100 80GB HBM3
# at 700 W; PERF.md section 6): prefill s and decode ms/step (slowest rank,
# the two runs), peak GiB a card, rank 0's collectives of the prefill and of
# one decode step {kind: (count, GB)}
SERVE_BEFORE = {"prefill_s": (0.8022, 0.8134),
                "decode_ms": (271.107, 272.180), "peak_gib": 19.921,
                "prefill": {"all-gather": (581, 35.8744),
                            "all-reduce": (128, 21.4748)},
                "decode": {"all-gather": (581, 35.8744),
                           "all-reduce": (128, 0.0052)}}
# phase 24 (--cards 4): hymba-1.5b on an NCCL world of one rank a card,
# mesh (data 1, model 4): its 25 query heads and 5 KV heads, which the
# model axis divides neither, dealt by sharding.head_ranges (10/5/5/5
# query heads, 2/1/1/1 KV heads), its 50 SSD heads by sharding.ssm_heads
# (13/13/12/12). The 2-layer check (layer 0 global, layer 1 windowed at
# 1,024) trains at phase 18's 4 x 4,096 tokens (the residual split over
# the sequence) and serves ATTN_CHECK_PROMPT, past the window; the full
# model generates ATTN_GENERATE and trains TRAIN_STEPS steps
ATTN_MESH_ARCH = "hymba-1.5b"
ATTN_MESH = (1, 4)
ATTN_CHECK_PROMPT = (2, 4_096)
ATTN_GENERATE = (4, 4_096, 32)
# phase 24's full-depth generate and steps on the tree that ran hymba's
# SSM whole on every model rank (its attention split; this script's
# lm_mesh_rank run with that tree's src first on sys.path by
# tools/serve_ab.py --phase 24, each tree in a process of its own, parent,
# change, change, parent, in the call that ran this tree's phase 24; four
# H100 80GB HBM3 at 700 W; PERF.md section 6): the generate as
# SERVE_BEFORE, the steps as MESH_BEFORE, each range the two parent runs
SSM_BEFORE = {
    "generate": {"prefill_s": (0.8257, 1.0986),
                 "decode_ms": (428.216, 444.271), "peak_gib": 3.402,
                 "prefill": {"all-gather": (482, 4.0805),
                             "all-reduce": (32, 3.3554),
                             "reduce-scatter": (32, 0.8389)},
                 "decode": {"all-gather": (417, 0.7250),
                            "all-reduce": (64, 0.0016)}},
    "train": {"step_s": (4.5197, 4.7704), "peak_gib": 17.134,
              "collectives": {"all-gather": (963, 11.616),
                              "all-reduce": (97, 5.033),
                              "reduce-scatter": (257, 1.036)}}}

# phase 25: the examples (examples_torch/) on the card. Each run: (tag,
# example, argv, the kernels it must launch). quickstart also at covtype's
# row count, device-resident, and streamed at its docstring's shape (rows,
# chunk)
EXAMPLE_STREAMED = (100_000, 16_384)
EXAMPLE_RUNS = (
    ("quickstart", "quickstart", [],
     ("rb_binning", "zt_matmul", "z_matmul_gather", "kmeans_assign",
      "kmeans_assign_stats")),
    ("quickstart covtype N", "quickstart",
     ["--n", str(COVTYPE[3]), "--grids", "256"], FIT_KERNELS),
    ("quickstart streamed", "quickstart",
     ["--n", str(EXAMPLE_STREAMED[0]), "--chunk-size",
      str(EXAMPLE_STREAMED[1])],
     ("rb_binning", "bin_counts", "zt_matmul", "z_matmul_gather",
      "kmeans_assign", "kmeans_assign_stats")),
    ("embed_cluster", "embed_cluster", [],
     ("flash_attention", "rb_binning", "zt_matmul", "z_matmul_gather",
      "kmeans_assign", "kmeans_assign_stats")),
    ("serve_predict", "serve_predict", [],
     ("rb_binning", "zt_matmul", "z_matmul_gather", "kmeans_assign",
      "kmeans_assign_stats")),
    ("serve_lm", "serve_lm", [], ("flash_attention",)),
    ("serve_lm internlm2", "serve_lm", ["--arch", "internlm2-1.8b"],
     ("flash_attention",)),
)
EXAMPLE_ARI = 0.99
EXAMPLE_CLI_S = 300.0
# embed_cluster's pretraining steps and serve_lm's prefill on the card
# against the CPU from the same weights: each step's loss (relative), the
# pooled embeddings (max error over the largest entry), the prefill's
# logits (absolute), all float32
EXAMPLE_LM_STEPS = 5
EXAMPLE_LM_TOL = {"loss_rel": 1e-5, "pool_rel": 1e-5, "logits_abs": 1e-4}
# planted flash faults, each with the measures of EXAMPLE_LM_TOL it must
# push over their limit (H = Hkv in embed_cluster's LM: the heads' map
# shows only in serve_lm's 4/2 GQA)
EXAMPLE_LM_FAULTS = {
    "causal mask off by one": ("loss_rel", "pool_rel", "logits_abs"),
    "kv heads mapped h % Hkv": ("logits_abs",)}
# phase 26: one eigensolver iteration of the clustering cell on four cards,
# a data shard of the reference's production cell a card (n 25 M over 16)
CELL = dict(n=6_250_000, n_grids=256, d_g=4_096, k=16)
CELL_ITERS = 10
CELL_BF16_REL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fn, iters: int = 50, warmup: int = 3,
                strict: bool = True) -> tuple[float, float]:
    """(device ms, host dispatch µs) per call of ``fn``, by CUDA events.

    For a kernel of microseconds ``time_ms`` times the host's dispatch: the
    device waits for each launch. Here the launches queue behind a spin
    kernel (``torch.cuda._sleep``) that outlasts their dispatch, so the
    events around them time the device alone. With ``strict`` the spin is
    lengthened until it outlasts the dispatch, or the call fails (a call
    that syncs with the host cannot be timed so; ``strict=False`` times it
    anyway)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    cycles = int(max(time.perf_counter() - t0, 1e-3) * 8e9)   # ~4x at 2 GHz
    for _ in range(4):
        spun, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spun.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if not strict or host * 1e3 < spun.elapsed_time(start):
            return start.elapsed_time(end) / iters, host / iters * 1e6
        cycles *= 4
    fail(f"the spin ({spun.elapsed_time(start):.3f} ms) ended before the "
         f"host had queued {iters} calls ({host * 1e3:.3f} ms)")


def bound(bytes_moved: float, ops: float,
          peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def strip_traffic(n: int, r: int, d_g: int, k: int, kc: int) -> dict:
    """Bytes the z strip kernel moves, from its launch geometry
    (csrc/ell_spmm.cu, launch_strip: tiles of at most 4,096 rows, cut so
    that the blocks fill whole waves of one block an SM): each block streams
    every strip of its column group, each group reads idx once, and every
    (row, grid, group) gathers kc float32 from shared memory."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = -(-k // kc)
    min_tiles = -(-n // 4096)
    waves = -(-min_tiles * groups // sms)
    tiles = max(min_tiles, waves * sms // groups)
    rows = -(-n // tiles)
    tile_rows = -(-rows // 32) * 32
    blocks = -(-n // tile_rows) * groups
    return {"blocks": blocks, "tile_rows": tile_rows,
            "strip": blocks * r * d_g * kc * 4, "idx": groups * n * r * 4,
            "smem": groups * n * r * kc * 4}


def within_sum_tolerance(got, want, abs_terms, rtol=1e-5, atol=1e-6):
    """Sums taken in another order agree to ``atol + rtol · Σ|terms|``:
    the float32 rounding of a sum is bounded by its absolute terms, not by
    its value (which may cancel to near 0)."""
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * abs_terms))
    return ok, float(err.max()) if err.numel() else 0.0


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase0_card() -> dict:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(f"[phase 0] card: {smi}")
    log(f"[phase 0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {device['count']}")
    return {"smi": smi, "device": device}


def sass_hot_loop(sass: str, kernel: str) -> list:
    """The instructions of ``kernel``'s hot loop in ``cuobjdump -sass``
    text: from the target of the first backward branch after the kernel's
    first FFMA.RM (the fast step's rounded-down add) to that branch."""
    import re
    for text in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in text.split("\n", 1)[0]:
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", text)]
        first = next(a for a, op in ins if "FFMA.RM" in op)
        for a, op in ins:
            target = re.search(r"BRA\s+(?:`?\(?)0x([0-9a-f]+)", op)
            if a > first and target and int(target.group(1), 16) <= first:
                lo = int(target.group(1), 16)
                return [op for b, op in ins if lo <= b <= a]
    fail(f"no hot loop of {kernel} found in the SASS")


def phase1_build() -> None:

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    for name, info in report.items():
        log(f"[phase 1] built {name} in {info['seconds']:.1f}s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 1]   {line.strip()}")
    for name in _build.LIBRARIES:
        _build.library(name)
    log(f"[phase 1] build + load {time.perf_counter() - t0:.1f}s")
    # rb_binning's fast step: no divide (MUFU), floor (FRND) or float -> int
    # conversion (F2I) left in its loop
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("rb_binning"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    hot = sass_hot_loop(sass, "rb_binning_kernel")
    hist: dict = {}
    for op in hot:
        word = op.split()[1] if op.startswith("@") else op.split()[0]
        hist[word.split(".")[0]] = hist.get(word.split(".")[0], 0) + 1
    log(f"[phase 1] rb_binning hot loop in SASS: {len(hot)} instructions "
        f"{dict(sorted(hist.items(), key=lambda kv: -kv[1]))}")
    slow = {k: hist[k] for k in ("MUFU", "FRND", "F2I") if k in hist}
    if slow:
        fail(f"rb_binning's hot loop still holds {slow}")


def kmeans_baseline(src: Path, emb, cents, lab, dist) -> None:
    """Build ``src`` (a kmeans_assign.cu of another tree), check it against
    this tree's kernel on (emb, cents) and time both on the device alone,
    alternating."""
    import ctypes
    import hashlib

    import torch

    from repro_torch.kernels import _build, ops
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"baseline-kmeans_assign-{h.hexdigest()[:16]}.so"
    if not out.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       capture_output=True, text=True, timeout=600,
                       check=True)
    fn = ctypes.CDLL(str(out)).kmeans_assign_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, k_d = emb.shape
    lab_b = torch.empty_like(lab)
    dist_b = torch.empty_like(dist)
    stream = torch.cuda.current_stream().cuda_stream

    def baseline():
        _build.check(fn(emb.data_ptr(), cents.data_ptr(), lab_b.data_ptr(),
                        dist_b.data_ptr(), n, k_d, cents.shape[0], stream),
                     "baseline kmeans_assign_launch")

    baseline()
    torch.cuda.synchronize()
    moved = int((lab_b != lab).sum())
    err = float((dist_b - dist).abs().max())
    log(f"[phase 2] baseline kmeans_assign ({src}): {moved} labels differ "
        f"from this tree's kernel, max distance difference {err:.3g}")
    if err > 1e-5:
        fail("the baseline kmeans_assign disagrees with this tree's kernel")
    times: dict = {"this tree": [], "baseline": []}
    for _ in range(2):
        for name, call in (("this tree", lambda: ops.kmeans_assign(emb, cents)),
                           ("baseline", baseline)):
            times[name].append(time_device(call)[0])
    for name, ms in times.items():
        log(f"[phase 2] kmeans_assign {name}: device ms "
            f"{', '.join(f'{t:.4f}' for t in ms)} (alternating)")


def phase2_kernels(x, fm, seed: int = 0, baseline_src=None) -> list:
    """Every kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core import eigensolver, graph
    from repro_torch.core.kmeans import row_normalize
    from repro_torch.kernels import ops, ref

    dev = x.device
    n, d = x.shape
    p = fm.params
    r, d_g, big_d = p.n_grids, p.d_g, p.n_features
    kb = EIG_BLOCK
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []

    # -- rb_binning: bit for bit -------------------------------------------
    args = (x, p.widths, p.biases, p.hash_a, p.hash_c)
    idx = ops.rb_binning(*args, d_g=d_g)
    want = ref.rb_binning_ref(*args, d_g)
    mism = int((idx != want).sum())
    if mism:
        fail(f"rb_binning differs from its plain version in {mism} entries")
    ms = time_ms(lambda: ops.rb_binning(*args, d_g=d_g))
    plain_ms = time_ms(lambda: ref.rb_binning_ref(*args, d_g), iters=2,
                       warmup=1)
    b_ms, b_by = bound(n * d * 4 + 3 * r * d * 4 + r * 4 + n * r * 4,
                       3.0 * n * r * d)
    rows.append(dict(name="rb_binning", route="cuda",
                     source="src/repro_torch/kernels/csrc/rb_binning.cu",
                     replaces="src/repro/kernels/rb_binning.py:74",
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     check="bit-exact on all rows and the planted rows"))
    del want
    # planted rows: quotients on an integer, one ulp off it, or rounded
    # onto it (row i and grid i hold triple i, d = 1), which the fast step
    # must hand to the exact one
    px, pb, pw, kinds = ref.rb_hard_cases(seed)
    prng = np.random.default_rng(seed)
    m = px.shape[0]
    pa = (prng.integers(0, 2**31 - 1, size=(m, 1)) * 2 + 1).astype(np.uint32)
    pc = prng.integers(0, 2**31 - 1, size=(m,)).astype(np.uint32)
    planted = [torch.from_numpy(a).to(dev) for a in
               (px[:, None], pw[:, None], pb[:, None], pa.view(np.int32),
                pc.view(np.int32))]
    mism = int((ops.rb_binning(*planted, d_g=d_g)
                != ref.rb_binning_ref(*planted, d_g)).sum())
    if mism:
        fail(f"rb_binning differs from its plain version in {mism} entries "
             "of the planted rows")
    log(f"[phase 2] rb_binning planted rows: {m} triples "
        f"{ {str(k): int((kinds == k).sum()) for k in sorted(set(kinds))} }, "
        f"{m * m} entries bit-exact")

    # -- the ELL products, on the fit's own pattern and row scales ----------
    adj = graph.build_normalized_adjacency(idx, d=big_d, d_g=d_g)
    s, csc = adj.rowscale, adj.csc
    u = torch.randn((n, kb), generator=g, device=dev)
    v = torch.randn((big_d, kb), generator=g, device=dev)
    idx_bytes = n * r * 4

    plan = ops.z_strip_plan(n, r, d_g, kb, v.dtype)
    if plan is None:
        fail(f"the main path's shape {(n, r, d_g, kb)} has no strip route")
    got = ops.z_matmul(idx, v, s, d_g=d_g)
    want = ref.z_matmul_ref(idx, v, s)
    ok, err = within_sum_tolerance(got, want,
                                   ref.z_matmul_ref(idx, v.abs(), s.abs()))
    if not ok:
        fail(f"z_matmul differs from its plain version (max abs {err:.3g})")
    gather = ops.z_matmul_gather(idx, v, s, d_g=d_g)
    if not torch.equal(got, gather):
        fail(f"the strip kernel differs from the gather kernel in "
             f"{int((got != gather).sum())} entries")
    del gather
    w_bag = s[:, None].expand(n, r).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        idx, v, mode="sum", per_sample_weights=w_bag))
    del w_bag
    b_ms, b_by = bound(*ops.z_matmul_cost(n, r, big_d, kb))
    z_ms = time_ms(lambda: ops.z_matmul(idx, v, s, d_g=d_g))
    rows.append(dict(name="z_matmul", route="cuda",
                     source="src/repro_torch/kernels/csrc/ell_spmm.cu",
                     replaces="src/repro/kernels/ell_spmm.py:85",
                     max_abs_err=err, ms=z_ms,
                     plain_ms=time_ms(lambda: ref.z_matmul_ref(idx, v, s),
                                      iters=3, warmup=1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     check="|err| <= 1e-6 + 1e-5 * sum|terms|; the same "
                           "bits as the gather kernel"))
    gather_ms = time_ms(lambda: ops.z_matmul_gather(idx, v, s, d_g=d_g))
    rows.append(engine_gather_row(idx, v, s, d_g, big_d))
    rows[-1]["buckets"] = engine_gather_buckets(idx, v, s, d_g)
    t = strip_traffic(n, r, d_g, kb, plan[0])
    log(f"[phase 2] z_matmul strip kernel (kc {plan[0]}, {plan[1]} stages, "
        f"{t['blocks']} blocks of {t['tile_rows']} rows) {z_ms:.4f} ms, the "
        f"gather kernel {gather_ms:.4f} ms: strips {t['strip'] / 1e9:.3f} GB "
        f"({t['strip'] / z_ms / 1e9:.3f} TB/s), idx {t['idx'] / 1e9:.3f} GB "
        f"through L2 ({idx_bytes / 1e9:.3f} GB once from memory), shared-"
        f"memory gathers {t['smem'] / 1e9:.3f} GB ({t['smem'] / z_ms / 1e9:.3f}"
        f" TB/s)")
    # the route's row threshold (ops.Z_STRIP_MIN_ROWS): both kernels on the
    # first rows of the pattern, the strip kernel forced below it
    keep = ops.Z_STRIP_MIN_ROWS
    ops.Z_STRIP_MIN_ROWS = 0
    for part in (keep // 2, keep):
        ip, sp = idx[:part], s[:part].contiguous()
        log(f"[phase 2] z_matmul on {part} rows: strip kernel "
            f"{time_ms(lambda: ops.z_matmul(ip, v, sp, d_g=d_g)):.4f} ms, "
            f"gather kernel "
            f"{time_ms(lambda: ops.z_matmul_gather(ip, v, sp, d_g=d_g)):.4f}"
            f" ms (the strip route starts at {keep} rows)")
    ops.Z_STRIP_MIN_ROWS = keep

    got = ops.zt_matmul(idx, u, s, big_d, d_g=d_g, csc=csc)
    want = ref.zt_matmul_ref(idx, u, s, big_d)
    zt_abs = ref.zt_matmul_ref(idx, u.abs(), s.abs(), big_d)
    ok, err = within_sum_tolerance(got, want, zt_abs)
    if not ok:
        fail(f"zt_matmul differs from its plain version (max abs {err:.3g})")
    src_rows = (u * s[:, None]).repeat_interleave(r, dim=0)
    flat = idx.reshape(-1)
    lib_ms = time_ms(lambda: torch.zeros((big_d, kb), device=dev).index_add_(
        0, flat, src_rows), iters=3, warmup=1)
    del src_rows
    b_ms, b_by = bound(*ops.zt_matmul_cost(n, r, big_d, kb))
    zt_ms = time_ms(lambda: ops.zt_matmul(idx, u, s, big_d, d_g=d_g,
                                          csc=csc))
    rows.append(dict(name="zt_matmul", route="cuda",
                     source="src/repro_torch/kernels/csrc/ell_spmm.cu",
                     replaces="src/repro/kernels/ell_spmm.py:222",
                     max_abs_err=err, ms=zt_ms,
                     plain_ms=time_ms(lambda: ref.zt_matmul_ref(
                         idx, u, s, big_d), iters=3, warmup=1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     check="|err| <= 1e-6 + 1e-5 * sum|terms|"))
    # what the gathers need: one padded su row (Kp floats, 16-byte aligned)
    # per nonzero, in 32-byte L2 sectors
    row_b = -(-kb // 4) * 16
    offsets = sorted({i * row_b % 32 for i in range(32)})
    sectors = sum((o + row_b - 1) // 32 + 1 for o in offsets) / len(offsets)
    gather = n * r * sectors * 32
    log(f"[phase 2] zt_matmul gather volume: {n * r} nonzeros x "
        f"{sectors:g} L2 sectors per {row_b}-byte row = {gather / 1e9:.3f} "
        f"GB, {gather / zt_ms / 1e9:.3f} TB/s at {zt_ms:.4f} ms (the bytes "
        f"bound, {b_ms:.4f} ms, counts idx and u once)")

    # -- bin_counts: exact; the CSC's column lengths; the streaming fit's
    # five chunks added into one buffer; two streams at once
    got = ops.bin_counts(idx, d=big_d, d_g=d_g)
    want = ref.bin_counts_ref(idx, big_d)
    if not torch.equal(got, want):
        fail(f"bin_counts differs from its plain version in "
             f"{int((got != want).sum())} columns")
    if not torch.equal((csc.colptr[1:] - csc.colptr[:-1]).to(torch.int32),
                       got):
        fail("bin_counts differs from the CSC's column lengths")
    summed = torch.zeros_like(got)
    chunks = range(0, n, STREAM_CHUNK)
    for i in chunks:
        ops.bin_counts(idx[i:i + STREAM_CHUNK], d=big_d, d_g=d_g, out=summed)
    if not torch.equal(summed, got):
        fail(f"bin_counts summed over {len(chunks)} chunks differs from the "
             "single-shot counts")
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    on = []
    for st in streams:
        with torch.cuda.stream(st):
            on.append(ops.bin_counts(idx, d=big_d, d_g=d_g))
    torch.cuda.synchronize()
    if not all(torch.equal(c, got) for c in on):
        fail("bin_counts launched on two streams at once differs")
    per_grid = got.view(r, d_g)
    share = (per_grid.max(dim=1).values.double() / n).cpu()
    q = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    occupied = (per_grid > 0).sum(1).double().cpu()
    log(f"[phase 2] the pattern's skew: the hottest bin's share of the rows "
        f"in a grid min/median/max "
        f"{[round(float(x), 4) for x in share.quantile(q)]}; occupied bins "
        f"a grid {[int(x) for x in occupied.quantile(q)]} of {d_g}; rows "
        f"whose bin equals the previous row's "
        f"{int((idx[1:] == idx[:-1]).sum()) / ((n - 1) * r):.4f}")
    hot = torch.randint(0, d_g, (r,), generator=g, device=dev,
                        dtype=torch.int32) + torch.arange(
        r, device=dev, dtype=torch.int32) * d_g
    planted = hot.expand(STREAM_CHUNK, r).contiguous()  # one bin a grid
    if not torch.equal(ops.bin_counts(planted, d=big_d, d_g=d_g),
                       ref.bin_counts_ref(planted, big_d)):
        fail("bin_counts miscounts the planted pattern (every row in one bin "
             "of each grid)")
    del planted
    bc_ms, bc_host = time_device(lambda: ops.bin_counts(idx, d=big_d,
                                                        d_g=d_g))
    part = idx[:STREAM_CHUNK]
    bc_chunk_ms, _ = time_device(lambda: ops.bin_counts(part, d=big_d,
                                                        d_g=d_g))
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=big_d))
    b_ms, b_by = bound(idx_bytes + big_d * 4, n * r)
    b_chunk, _ = bound(STREAM_CHUNK * r * 4 + big_d * 4, STREAM_CHUNK * r)
    rows.append(dict(name="bin_counts", route="cuda",
                     source="src/repro_torch/kernels/csrc/bin_counts.cu",
                     replaces="src/repro/kernels/ops.py:186",
                     max_abs_err=0.0, ms=bc_ms,
                     plain_ms=time_ms(lambda: ref.bin_counts_ref(idx, big_d),
                                      iters=3, warmup=1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     check="equal to its plain version, to the CSC's column "
                           f"lengths and to the sum of {len(chunks)} chunks; "
                           "the same on two streams; exact on every row in "
                           "one bin a grid"))
    log(f"[phase 2] bin_counts on one chunk of {STREAM_CHUNK} rows (the "
        f"streaming degree pass): {bc_chunk_ms:.4f} ms on the device, bound "
        f"{b_chunk:.4f} ms; whole pattern {bc_ms:.4f} ms "
        f"({(idx_bytes + big_d * 4) / bc_ms / 1e9:.3f} TB/s), host dispatch "
        f"{bc_host:.1f} us a call")
    del summed, on, want

    # -- the Gram operator: the fused kernel, against zt then z ------------
    got = ops.gram_matmul(idx, u, s, big_d, d_g=d_g, csc=csc)
    composed = lambda: ops.z_matmul(
        idx, ops.zt_matmul(idx, u, s, big_d, d_g=d_g, csc=csc), s, d_g=d_g)
    if not torch.equal(got, composed()):
        fail(f"the fused Gram kernel differs from zt_matmul then z_matmul in "
             f"{int((got != composed()).sum())} entries")
    want = ref.z_matmul_ref(idx, ref.zt_matmul_ref(idx, u, s, big_d), s)
    terms = ref.z_matmul_ref(
        idx, ref.zt_matmul_ref(idx, u.abs(), s.abs(), big_d), s.abs())
    ok, err = within_sum_tolerance(got, want, terms)
    if not ok:
        fail(f"gram_matmul differs from its plain version (max abs {err:.3g})")
    del want, terms
    # the pattern twice (CSC row ids and idx), the column pointer, u, s, y
    gram_bytes, gram_ops = ops.gram_matmul_cost(n, r, big_d, kb)
    gram_bound, gram_by = bound(gram_bytes, gram_ops)
    gram_ms = time_ms(lambda: ops.gram_matmul(idx, u, s, big_d, d_g=d_g,
                                              csc=csc))
    composed_ms = time_ms(composed)
    rows.append(dict(name="gram_matmul", route="cuda",
                     source="src/repro_torch/kernels/csrc/ell_spmm.cu",
                     replaces="src/repro/kernels/ell_spmm.py:180",
                     max_abs_err=err, ms=gram_ms,
                     plain_ms=time_ms(lambda: ref.z_matmul_ref(
                         idx, ref.zt_matmul_ref(idx, u, s, big_d), s),
                         iters=3, warmup=1),
                     bound_ms=gram_bound, bound_by=gram_by, library_ms=None,
                     check="the bits of zt_matmul then z_matmul; |err| <= "
                           "1e-6 + 1e-5 * sum|terms|"))
    log(f"[phase 2] gram_matmul fused kernel {gram_ms:.4f} ms, zt_matmul "
        f"then z_matmul {composed_ms:.4f} ms (the same bits); bound "
        f"{gram_bound:.4f} ms: {gram_bytes / 1e9:.3f} GB at "
        f"{gram_bytes / gram_ms / 1e9:.3f} TB/s")
    # the dense LOBPCG algebra around each Gram product, at the same shape
    x_blk = torch.linalg.qr(u)[0]
    w_blk = torch.randn((n, kb), generator=g, device=dev)
    res_ms = time_ms(lambda: eigensolver._lobpcg_residual_block(
        x_blk, u, 1e-4, s), iters=5)
    rr_ms = time_ms(lambda: eigensolver._lobpcg_rr_update(
        x_blk, u, w_blk, u, w_blk, u, kb), iters=5)
    log(f"[phase 2] lobpcg dense algebra per iteration (N={n}, b={kb}): "
        f"residual_block ms={res_ms:.4f} rr_update ms={rr_ms:.4f}")

    # -- kmeans_assign and its statistics form, on a row-normalized 7-wide
    # embedding; timed on the device alone (time_device)
    k_cl = COVTYPE[1]
    emb = row_normalize(torch.randn((n, k_cl), generator=g, device=dev))
    cents = emb[torch.randperm(n, generator=g, device=dev)[:k_cl]].contiguous()
    lab, dist = ops.kmeans_assign(emb, cents)
    lab_p, dist_p = ref.kmeans_assign_ref(emb, cents)
    d2 = (emb * emb).sum(-1, keepdim=True) - 2.0 * emb @ cents.T \
        + (cents * cents).sum(-1)[None]
    two = torch.topk(d2, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-6
    bad = int(((lab != lab_p) & clear).sum())
    err = float((dist - dist_p).abs().max())
    if bad or err > 1e-5:
        fail(f"kmeans_assign differs from its plain version: {bad} labels "
             f"where the best two distances differ by > 1e-6, max distance "
             f"error {err:.3g}")
    b_ms, b_by = bound(n * k_cl * 4 + k_cl * k_cl * 4 + n * 8,
                       3.0 * n * k_cl * k_cl)
    small = {  # name: (call, strict)
        "kmeans_assign": (lambda: ops.kmeans_assign(emb, cents), True),
        "plain kmeans_assign_ref": (
            lambda: ref.kmeans_assign_ref(emb, cents), True),
        "cdist + argmin": (lambda: torch.cdist(emb, cents).argmin(1), True),
        "kmeans_assign_stats": (
            lambda: ops.kmeans_assign_stats(emb, cents), True),
        "plain kmeans_assign_stats_ref": (
            lambda: ref.kmeans_assign_stats_ref(emb, cents), False),
        "the old Lloyd step (kmeans_assign, bincount, one-hot product)": (
            lambda: old_lloyd_step(emb, cents), False),
        "the Lloyd step (kmeans_assign_stats, centroid update)": (
            lambda: lloyd_step(emb, cents), True)}
    dev_ms = {}
    for name, (call, strict) in small.items():
        dev_ms[name], host_us = time_device(call, strict=strict)
        log(f"[phase 2] {name}: device {dev_ms[name]:.4f} ms, host "
            f"dispatch {host_us:.1f} us per call"
            + ("" if strict else " (syncs with the host: not device alone)"))
    if baseline_src is not None:
        kmeans_baseline(baseline_src, emb, cents, lab, dist)
    rows.append(dict(name="kmeans_assign", route="cuda",
                     source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
                     replaces="src/repro/kernels/kmeans_assign.py:41",
                     max_abs_err=err, ms=dev_ms["kmeans_assign"],
                     plain_ms=dev_ms["plain kmeans_assign_ref"],
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=dev_ms["cdist + argmin"],
                     check="labels equal where top-2 gap > 1e-6; "
                           "|dist err| <= 1e-5"))
    # the statistics form: the kernel's labels, bincount's counts exactly,
    # the plain one-hot product's sums on those labels within the sum
    # tolerance, the same bits twice
    stats = ops.kmeans_assign_stats(emb, cents)
    lab_s, counts, sums, inertia = stats
    onehot = torch.nn.functional.one_hot(lab.long(), k_cl).float()
    if not torch.equal(lab_s, lab):
        fail("kmeans_assign_stats' labels differ from kmeans_assign's")
    if not torch.equal(counts, torch.bincount(lab, minlength=k_cl).float()):
        fail(f"kmeans_assign_stats' counts {counts.tolist()} differ from "
             "bincount's")
    ok_s, err_s = within_sum_tolerance(sums, onehot.T @ emb,
                                       onehot.T @ emb.abs())
    ok_i, err_i = within_sum_tolerance(inertia, dist.sum(), dist.sum())
    if not (ok_s and ok_i):
        fail(f"kmeans_assign_stats' sums (max abs {err_s:.3g}) or inertia "
             f"({err_i:.3g}) differ from the plain version's")
    if not all(torch.equal(a, b) for a, b in
               zip(stats, ops.kmeans_assign_stats(emb, cents))):
        fail("two runs of kmeans_assign_stats differ")
    e_len = k_cl * (k_cl + 1) + 1
    b_ms, b_by = bound(n * k_cl * 4 + k_cl * k_cl * 4 + n * 4 + e_len * 4,
                       3.0 * n * k_cl * k_cl + n * (k_cl + 1))
    rows.append(dict(name="kmeans_assign_stats", route="cuda",
                     source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
                     replaces="src/repro/kernels/ops.py:395",
                     max_abs_err=max(err_s, err_i),
                     ms=dev_ms["kmeans_assign_stats"],
                     plain_ms=dev_ms["plain kmeans_assign_stats_ref"],
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     check="labels of kmeans_assign; counts equal to "
                           "bincount's; sums and inertia |err| <= 1e-6 + "
                           "1e-5 * sum|terms|; the same bits twice"))
    for row in rows:
        log(f"[phase 2] {row['name']}: ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) library_ms={row['library_ms']} "
            f"max_abs_err={row['max_abs_err']:.3g} ok ({row['check']})")
    return rows


def old_lloyd_step(x, cents):
    """The port's Lloyd step before the statistics form: the assignment,
    ``bincount`` (which reads the labels' range back to the host) and a
    one-hot product, then the centroid update."""
    import torch

    from repro_torch.kernels import ops
    k = cents.shape[0]
    labels, _ = ops.kmeans_assign(x, cents)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(x.dtype)
    new = (onehot.T @ x) / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new, cents)


def lloyd_step(x, cents):
    """One step of ``core.kmeans._lloyd``'s loop."""
    import torch

    from repro_torch.kernels import ops
    _, counts, sums, _ = ops.kmeans_assign_stats(x, cents)
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new, cents)


def kmeans_split(model, cfg) -> None:
    """The fit's kmeans stage split into k-means++ seeding and Lloyd steps:
    ``core.kmeans.kmeans``'s calls, from the same generator, on the fitted
    embedding, timed by the host clock after a device synchronise. They
    must give the fit's labels."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.utils import fold_seed, make_generator
    km = importlib.import_module("repro_torch.core.kmeans")
    emb = torch.as_tensor(model.fit_result.embedding, device="cuda",
                          dtype=torch.float32).contiguous()
    gen = make_generator(fold_seed(cfg.seed, "kmeans"), "cuda")
    seeding = lloyd = 0.0
    best = None
    for _ in range(cfg.kmeans_replicates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cents = km._plusplus_init(gen, emb, cfg.n_clusters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = km._lloyd(emb, cents, cfg.kmeans_iters, cfg.impl)
        torch.cuda.synchronize()
        seeding += t1 - t0
        lloyd += time.perf_counter() - t1
        if best is None or float(res.inertia) < float(best.inertia):
            best = res
    same = np.array_equal(best.labels.cpu().numpy(), model.fit_result.labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km.kmeans(make_generator(fold_seed(cfg.seed, "kmeans"), "cuda"), emb,
              cfg.n_clusters, n_iters=cfg.kmeans_iters,
              n_replicates=cfg.kmeans_replicates, impl=cfg.impl)
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    log(f"[phase 3] kmeans stage by the same calls: k-means++ seeding "
        f"{seeding:.4f}s, Lloyd steps {lloyd:.4f}s ({cfg.kmeans_replicates} "
        f"replicates x {cfg.kmeans_iters} steps + a last assignment); labels "
        f"identical to the fit's = {same}; core.kmeans.kmeans once more as "
        f"one call {whole:.4f}s")
    if not same:
        fail("the kmeans stage's calls on the fitted embedding do not give "
             "the fit's labels")


def phase3_fit(x_np, y_np, cfg):
    import torch

    from repro_torch.core import SCRBModel, metrics
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model = SCRBModel.fit(x_np, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = model.fit_result
    diag = res.diagnostics
    log(f"[phase 3] fit N={x_np.shape[0]} d={x_np.shape[1]} "
        f"K={cfg.n_clusters} R={cfg.n_grids} sigma={cfg.sigma:.6g} "
        f"d_g={diag['d_g']} D={diag['n_features_D']} in {wall:.2f}s")
    log("[phase 3] stages (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in res.timer.times.items()))
    log(f"[phase 3] solver_iterations={diag['solver_iterations']} "
        f"(zt then z: {FIT_ITERATIONS}) "
        f"resnorms={[float(f'{r:.3g}') for r in diag['solver_resnorms']]} "
        f"singular_values={[float(f'{s:.5f}') for s in res.singular_values]}")
    log(f"[phase 3] ACC={metrics.accuracy(res.labels, y_np):.4f} "
        f"NMI={metrics.nmi(res.labels, y_np):.4f} against the synthetic "
        "truth (for information)")
    log(f"[phase 3] max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[phase 3] kernel launches during the fit: {counts}")
    missing = [k for k in FIT_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"the fit launched no {missing} kernel")
    if counts["z_matmul_gather"]:
        fail(f"{counts['z_matmul_gather']} z products of the fit took the "
             "gather kernel, not the strip kernel")
    if counts["gram_matmul_composed"]:
        fail(f"{counts['gram_matmul_composed']} Gram products of the fit "
             f"took zt then z, not the fused kernel "
             f"({counts['gram_matmul']} did)")
    if diag["solver_iterations"] != FIT_ITERATIONS:
        fail(f"LOBPCG stopped after {diag['solver_iterations']} iterations, "
             f"not {FIT_ITERATIONS} as with zt then z")
    kmeans_split(model, cfg)
    if res.labels.shape != (x_np.shape[0],):
        fail(f"labels have shape {res.labels.shape}")
    return model, counts


def phase4_serve(model, x_np):
    from repro_torch.core import SCRBModel, metrics
    from repro_torch.kernels import ops

    fit_labels = model.fit_result.labels
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.npz")
        model.save(path)
        size = Path(path).stat().st_size
        ops.reset_launch_counts()
        served = SCRBModel.load(path, device="cuda")
        log(f"[phase 4] saved and loaded a {size / 2**20:.2f} MiB artifact "
            f"(state {served.nbytes} bytes)")
        for n_req in SERVE_REQUESTS:
            t0 = time.perf_counter()
            pred = served.predict(x_np[:n_req])
            dt = time.perf_counter() - t0
            acc = metrics.accuracy(pred, fit_labels[:n_req])
            log(f"[phase 4] predict {n_req} rows: {dt * 1e3:.2f} ms, "
                f"agreement with the fit labels {acc:.4f}")
            if acc < 0.99:
                fail(f"predict agrees with the fit labels at {acc:.4f} < 0.99")
        rows = x_np[:SERVE_BATCH_ROWS]
        served.predict(rows[:4096], batch_size=4096)        # warm the buckets
        t0 = time.perf_counter()
        pred = served.predict(rows, batch_size=4096)
        dt = time.perf_counter() - t0
        acc = metrics.accuracy(pred, fit_labels[:SERVE_BATCH_ROWS])
        log(f"[phase 4] predict {SERVE_BATCH_ROWS} rows (batch_size=4096): "
            f"{dt:.3f} s, {SERVE_BATCH_ROWS / dt:.0f} rows/s, agreement "
            f"{acc:.4f}")
        if acc < 0.99:
            fail(f"predict agrees with the fit labels at {acc:.4f} < 0.99")
        log(f"[phase 4] kernel launches while serving: {ops.launch_counts()}")


def phase5_determinism(x_np, cfg):
    import numpy as np

    from repro_torch.core import sc_rb

    xs = x_np[:DETERMINISM_ROWS]
    t0 = time.perf_counter()
    a = sc_rb(xs, cfg).labels
    b = sc_rb(xs, cfg).labels
    same = bool(np.array_equal(a, b))
    log(f"[phase 5] two fits of {DETERMINISM_ROWS} rows in "
        f"{time.perf_counter() - t0:.2f}s: labels identical = {same}")
    if not same:
        fail(f"two fits differ in {int((a != b).sum())} labels")


def row_errors(got, want):
    """Relative L2 error of each row (last axis) of ``got``."""
    err = (got.float() - want.float()).norm(dim=-1)
    return err / want.float().norm(dim=-1).clamp_min(1e-30)


def row_error(got, want) -> float:
    """Largest relative L2 error over the rows (last axis) of ``got``."""
    return float(row_errors(got, want).max())


def checked_attention(attn, rows: list):
    """``attn`` (``ops.flash_attention``'s signature), with each call's row
    error against the plain version on the same inputs appended to
    ``rows``."""
    from repro_torch.kernels.ref import flash_attention_bshd_ref as plain

    def run(q, k, v, *, causal=True, window=None):
        out = attn(q, k, v, causal=causal, window=window)
        rows.append(row_error(out, plain(q, k, v, causal=causal,
                                          window=window)))
        return out
    return run


def planted_faults() -> dict:
    """Causal attention with a planted fault, each computed by the plain
    version: what a kernel with that bug returns. ``ops.flash_attention``'s
    signature, for the prefill's case (causal, no window)."""
    import torch

    from repro_torch.kernels.ref import flash_attention_bshd_ref as plain

    def off_by_one(q, k, v, *, causal=True, window=None):
        # the causal mask lets key qpos + 1 through
        q1 = torch.cat([torch.zeros_like(q[:, :1]), q], dim=1)
        return plain(q1, k, v)[:, 1:]

    def diagonal_tile_dropped(q, k, v, *, causal=True, window=None):
        # each block of rows skips its last live key tile
        out = torch.zeros_like(q)
        for r0 in range(FLASH_TILE, q.shape[1], FLASH_TILE):
            rows = slice(r0, r0 + FLASH_TILE)
            out[:, rows] = plain(q[:, rows], k[:, :r0], v[:, :r0],
                                 causal=False)
        return out

    def heads_mixed(q, k, v, *, causal=True, window=None):
        # head h reads kv head h % Hkv, not h // (H / Hkv)
        rep = q.shape[2] // k.shape[2]
        return plain(q, k.repeat(1, 1, rep, 1), v.repeat(1, 1, rep, 1))

    return {"causal mask off by one": off_by_one,
            "diagonal key tile dropped": diagonal_tile_dropped,
            "kv heads mapped h % Hkv": heads_mixed}


def visible_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs that the mask lets through, per (batch, head)."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def phase6_flash(seed: int) -> dict:
    """The flash kernel against its plain version: every small case, then
    the LM prefill's shape with times, bound and SDPA as the yardstick, and
    the planted faults against the same check."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_bshd_ref as plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def inputs(b, s, t, h, hkv, hd, dtype):
        dt = getattr(torch, dtype)
        return (torch.randn((b, s, h, hd), generator=g, device=dev).to(dt),
                torch.randn((b, t, hkv, hd), generator=g, device=dev).to(dt),
                torch.randn((b, t, hkv, hd), generator=g, device=dev).to(dt))

    def check(what, got, want, dtype) -> tuple[float, float]:
        tol = FLASH_TOL[dtype]
        err = (got.float() - want.float()).abs()
        row = row_error(got, want)
        if bool((err > tol * (1 + want.float().abs())).any()) \
                or (dtype == "bfloat16" and row > FLASH_ROW_REL):
            fail(f"flash_attention {what} differs from its plain version: "
                 f"max abs {float(err.max()):.3g} (limit {tol} (1 + |want|))"
                 f", row error {row:.3g} (bf16 limit {FLASH_ROW_REL})")
        return float(err.max()), row

    for case in FLASH_SMALL:
        b, s, t, h, hkv, hd, causal, window = case
        for dtype in FLASH_TOL:
            q, k, v = inputs(b, s, t, h, hkv, hd, dtype)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = plain(q, k, v, causal=causal, window=window)
            err, row_err = check(f"{case} {dtype}", got, want, dtype)
            log(f"[phase 6] flash_attention {case} {dtype}: max_abs_err="
                f"{err:.3g} row error {row_err:.3g} ok")

    b, s, t, h, hkv, hd = FLASH_PATH
    q, k, v = inputs(b, s, t, h, hkv, hd, "bfloat16")
    got = ops.flash_attention(q, k, v, causal=True)
    want = plain(q, k, v, causal=True)
    err, row_err = check(f"at the prefill's shape {FLASH_PATH}", got, want,
                     "bfloat16")
    del got
    for name, fault in planted_faults().items():
        row_f = row_error(fault(q, k, v), want)
        log(f"[phase 6] planted fault at the prefill's shape, {name}: row "
            f"error {row_f:.3g} (limit {FLASH_ROW_REL}) -> fails the check")
        if row_f <= FLASH_ROW_REL:
            fail(f"the flash check passes a planted fault ({name})")
    del want
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = time_ms(lambda: plain(q, k, v, causal=True), iters=3,
                       warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    pairs = visible_pairs(s, t, True, None)
    b_ms, b_by = bound(2 * (2 * b * s * h * hd + 2 * b * t * hkv * hd),
                       4.0 * hd * pairs * b * h, PEAK_BF16_OPS_PER_S)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:98",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms)
    log(f"[phase 6] flash_attention B={b} S={s} T={t} H={h} Hkv={hkv} "
        f"hd={hd} bf16 causal: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms:.4f} (SDPA) "
        f"max_abs_err={err:.3g} row error {row_err:.3g} ok; "
        f"{4.0 * hd * pairs * b * h / ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / ms:.1%} of the bound")
    del q, k, v

    # stablelm-12b's head dim 160, checked and timed
    b, s, t, h, hkv, hd = FLASH_HD160
    q, k, v = inputs(b, s, t, h, hkv, hd, "bfloat16")
    err, row_err = check(f"at {FLASH_HD160}", ops.flash_attention(q, k, v),
                         plain(q, k, v), "bfloat16")
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    ops_160 = 4.0 * hd * visible_pairs(s, t, True, None) * b * h
    b160, by160 = bound(2 * (2 * b * s * h * hd + 2 * b * t * hkv * hd),
                        ops_160, PEAK_BF16_OPS_PER_S)
    log(f"[phase 6] flash_attention B={b} S={s} T={t} H={h} Hkv={hkv} "
        f"hd={hd} bf16 causal: ms={ms:.4f} bound_ms={b160:.4f} ({by160}) "
        f"SDPA ms={sdpa_ms:.4f} max_abs_err={err:.3g} row error "
        f"{row_err:.3g} ok; {ops_160 / ms / 1e9:.1f} TFLOP/s, "
        f"{b160 / ms:.1%} of the bound")
    return row


def phase7_lm(seed: int) -> int:
    """LM serving at full width; returns the flash launches of one
    generate."""
    import copy
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_bshd_ref as plain
    from repro_torch.models import transformer as T

    cfg = configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters, the config counts {cfg.param_count()}")
    log(f"[phase 7] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"H={cfg.n_heads}/{cfg.n_kv_heads}, hd={cfg.head_dim}, "
        f"d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, {cfg.dtype}: {n_params} "
        f"parameters drawn on the card in {time.perf_counter() - t0:.2f}s")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}

    def prefill_logits(attn, cfg_, params_):
        """Last-position prefill logits with ``attn`` as the flash op."""
        with mock.patch.object(ops, "flash_attention", attn):
            return T.prefill(cfg_, params_, batch,
                             T.init_cache(cfg_, LM_BATCH, LM_CACHE))[0]

    # every layer's kernel output against the plain version on its inputs;
    # the prefill logits through the kernel and through the plain
    # attention, both against the float32 truth
    rows: list = []
    logits = prefill_logits(checked_attention(ops.flash_attention, rows),
                            cfg, params)
    plain_logits = prefill_logits(plain, cfg, params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = copy.deepcopy(params).float()
    truth = prefill_logits(plain, cfg32, params32)
    del params32
    torch.cuda.empty_cache()
    rel = lambda a, b: float((a - b).norm() / b.norm())
    err_k, err_p = rel(logits, truth), rel(plain_logits, truth)
    top1 = float((logits.argmax(-1) == truth.argmax(-1)).float().mean())
    log(f"[phase 7] kernel vs plain attention on each layer's prefill "
        f"inputs (B={LM_BATCH} S={LM_PROMPT} H={cfg.n_heads} "
        f"Hkv={cfg.n_kv_heads}): row error max {max(rows):.3g} over "
        f"{len(rows)} layers (limit {FLASH_ROW_REL}), layer 0 {rows[0]:.3g}")
    if len(rows) != cfg.n_layers or max(rows) > FLASH_ROW_REL:
        fail(f"the kernel's attention in prefill differs from the plain "
             f"version: row errors {rows}")
    log(f"[phase 7] prefill logits vs the float32 truth (rel L2): kernel "
        f"{err_k:.4g}, plain bf16 attention {err_p:.4g} (kernel vs plain "
        f"{rel(logits, plain_logits):.4g}); max abs kernel "
        f"{float((logits - truth).abs().max()):.3g}, |logits| max "
        f"{float(truth.abs().max()):.3g}; top-1 agreement with the truth "
        f"{top1:.2f}")
    if not bool(torch.isfinite(logits).all()) \
            or err_k > LM_ERR_RATIO * err_p:
        fail(f"prefill logits through the kernel are {err_k:.4g} off the "
             f"float32 truth, more than {LM_ERR_RATIO} x the plain "
             f"attention's {err_p:.4g}")
    for name, fault in planted_faults().items():
        rows_f: list = []
        err_f = rel(prefill_logits(checked_attention(fault, rows_f), cfg,
                                   params), truth)
        log(f"[phase 7] planted fault, {name}: layer row error max "
            f"{max(rows_f):.3g}, layer 0 {rows_f[0]:.3g} (limit "
            f"{FLASH_ROW_REL}); logits {err_f:.4g} off the truth, "
            f"{err_f / err_p:.3g} x the plain attention's (the logit gate "
            f"{'fails' if err_f > LM_ERR_RATIO * err_p else 'passes'} it)")
        if rows_f[0] <= FLASH_ROW_REL:
            fail(f"the per-layer check passes a planted fault ({name})")
    del logits, plain_logits, truth

    launches = serve_requests("[phase 7]", cfg, params, prompts, seed,
                              flash_layers=cfg.n_layers)["launches"]
    return launches["flash_attention"]


def serve_requests(tag: str, cfg, params, prompts, seed: int, *,
                   flash_layers: int, new: "int | None" = None
                   ) -> dict:
    """Phase 7's, 16's and 17's requests through ``Engine.generate``,
    ``new`` tokens each: greedy twice (the same tokens) and at
    LM_TEMPERATURE twice from one seed (the same tokens), with prefill s,
    TTFT, decode ms/step, peak memory and the kernel launches of one
    generate (the flash kernel's must be ``flash_layers``). Returns those
    launches, the greedy run's stats and tokens."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine, ServeConfig

    new = new or LM_NEW
    engine = Engine(cfg, params, ServeConfig(cache_len=LM_CACHE,
                                             batch_size=LM_BATCH))
    engine.generate(prompts[:, :256], 2)                    # warm up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    greedy = engine.generate(prompts, new, seed=seed)
    launches = ops.launch_counts()
    flash = launches["flash_attention"]
    stats = st = engine.last_stats
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_tok = LM_BATCH * st["decode_steps"]
    log(f"{tag} generate greedy: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
        f"{new} new each: prefill {st['prefill_s']:.4f}s "
        f"({st['prompt_tokens'] / st['prefill_s']:.0f} prompt tokens/s), "
        f"time to first token {st['ttft_s']:.4f}s, decode "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms/step over "
        f"{st['decode_steps']} steps ({decode_tok / st['decode_s']:.1f} "
        f"tokens/s), peak device memory {peak:.3f} GiB")
    log(f"{tag} flash_attention launches in one generate: {flash} "
        f"(layers through it: {flash_layers}); all launches {launches}")
    if flash != flash_layers:
        fail(f"{cfg.name}: one generate launched the flash kernel {flash} "
             f"times, not once per layer through it ({flash_layers})")
    if greedy.shape != (LM_BATCH, new) or greedy.min() < 0 \
            or greedy.max() >= cfg.vocab_size:
        fail(f"{cfg.name}: greedy tokens of shape {greedy.shape} out of "
             "the vocabulary")
    again = engine.generate(prompts, new, seed=seed)
    if not np.array_equal(greedy, again):
        fail(f"{cfg.name}: two greedy generates differ in "
             f"{int((greedy != again).sum())} tokens")
    log(f"{tag} two greedy generates: identical tokens "
        f"(first request: {greedy[0, :8].tolist()} ...)")

    sampler = Engine(cfg, params, ServeConfig(
        cache_len=LM_CACHE, batch_size=LM_BATCH, temperature=LM_TEMPERATURE))
    hot = sampler.generate(prompts, new, seed=seed)
    st = sampler.last_stats
    same = np.array_equal(hot, sampler.generate(prompts, new, seed=seed))
    log(f"{tag} generate at temperature {LM_TEMPERATURE}: ttft "
        f"{st['ttft_s']:.4f}s, decode "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms/step; tokens "
        f"differ from greedy in {int((hot != greedy).sum())} of {hot.size}; "
        f"same seed, same tokens = {same}")
    if not same or hot.min() < 0 or hot.max() >= cfg.vocab_size:
        fail(f"{cfg.name}: sampling at a temperature is not reproducible "
             "from its seed")
    return {"launches": launches, "stats": stats, "greedy": greedy}


def phase8_streaming(x_np, y_np, cfg, device_fit) -> dict:
    """The host-chunked fit at covtype scale against the device-resident
    fit of phase 3 (``device_fit``: its labels, embedding and singular
    values), its memory at half the rows, and a save → load → predict of
    the chunked model. Returns the launch counts of the full-N fit."""
    import importlib
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.core import SCRBModel, metrics, streaming
    from repro_torch.kernels import ops
    from repro_torch.utils import fold_seed, make_generator
    km = importlib.import_module("repro_torch.core.kmeans")

    cfg_c = dataclasses.replace(cfg, chunk_size=STREAM_CHUNK)
    gram = streaming.ChunkedELL.gram_matvec_chunked
    sweeps = {"n": 0, "s": 0.0, "bytes": 0}

    def timed_gram(store, u):
        """The LOBPCG operator, timed (host clock after a synchronise) and
        its uploads counted."""
        torch.cuda.synchronize()
        b0, t0 = store.h2d_stats.get("bytes", 0), time.perf_counter()
        out = gram(store, u)
        torch.cuda.synchronize()
        sweeps["s"] += time.perf_counter() - t0
        sweeps["n"] += 1
        sweeps["bytes"] += store.h2d_stats["bytes"] - b0
        return out

    def fit(x, c=cfg_c):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(streaming.ChunkedELL, "gram_matvec_chunked",
                               timed_gram):
            model = SCRBModel.fit(x, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (model, wall, ops.launch_counts(),
                torch.cuda.max_memory_allocated() - base)

    model, wall, counts, peak = fit(x_np)
    res = model.fit_result
    diag = res.diagnostics
    n = x_np.shape[0]
    cos = subspace_cosine(res.embedding, device_fit["embedding"])
    log(f"[phase 8] host-chunked fit N={n} chunk_size={STREAM_CHUNK} in "
        f"{wall:.2f}s; stages (s): " + ", ".join(
            f"{k}={v:.3f}" for k, v in res.timer.times.items()))
    acc_lloyd = metrics.accuracy(res.labels, device_fit["labels"])
    # the same k-means (streaming_kmeans, same generator and step count)
    # over the device fit's embedding in the same chunks: rows are drawn by
    # index and distance, so a sign flip of an eigenvector changes nothing
    same_alg = km.streaming_kmeans(
        make_generator(fold_seed(cfg.seed, "kmeans"), "cuda"),
        streaming.ChunkedDense.from_array(device_fit["embedding"],
                                          STREAM_CHUNK),
        cfg.n_clusters, n_steps=diag["kmeans_steps"],
        n_replicates=cfg.kmeans_replicates, impl=cfg.impl, device="cuda")
    acc_dev = metrics.accuracy(res.labels, same_alg.labels.numpy())
    theta_c = np.asarray(res.singular_values, np.float64) ** 2
    theta_d = np.asarray(device_fit["singular_values"], np.float64) ** 2
    rel = float(np.max(np.abs(theta_c - theta_d) / np.abs(theta_d)))
    log(f"[phase 8] solver_iterations={diag['solver_iterations']} (the "
        f"device fit: {device_fit['iterations']}) resnorms="
        f"{[float(f'{r:.3g}') for r in diag['solver_resnorms']]}; Ritz "
        f"values {[float(f'{t:.6f}') for t in theta_c]} against the device "
        f"fit's {[float(f'{t:.6f}') for t in theta_d]}: max relative "
        f"difference {rel:.3g} (limit 1e-3)")
    log(f"[phase 8] embedding span against the device fit's: principal-"
        f"angle cosines >= {cos:.9f} (limit 1 - 1e-3)")
    log(f"[phase 8] ACC={metrics.accuracy(res.labels, y_np):.4f} against "
        f"the synthetic truth (device fit "
        f"{metrics.accuracy(device_fit['labels'], y_np):.4f}); "
        f"streaming_kmeans, {diag['kmeans_steps']} steps: agreement with "
        f"the same k-means over the device fit's embedding {acc_dev:.4f} "
        f"(limit 0.99; its inertia {float(same_alg.inertia):.6g}), with the "
        f"device fit's Lloyd labels {acc_lloyd:.4f} (not gated); k-means "
        f"inertia {diag['kmeans_inertia']:.6g} (device fit's Lloyd "
        f"{device_fit['inertia']:.6g})")
    resid = {k: diag[k] for k in ("n_chunks", "chunk_rows_max",
                                  "ell_device_bytes_peak",
                                  "embedding_device_bytes_peak",
                                  "h2d_max_chunk_bytes", "prefetch")}
    log(f"[phase 8] residency diagnostics: {resid}")
    per = sweeps["s"] / max(sweeps["n"], 1)
    svd = res.timer.times["svd"]
    log(f"[phase 8] Gram sweeps (zt over each chunk's CSC, then z over its "
        f"idx): {sweeps['n']} in the svd stage, {per * 1e3:.1f} ms and "
        f"{sweeps['bytes'] / max(sweeps['n'], 1) / 1e9:.3f} GB of H2D each "
        f"({sweeps['bytes'] / max(sweeps['s'], 1e-9) / 1e9:.2f} GB/s); "
        f"{sweeps['s']:.2f} s of the svd stage's {svd:.2f} s "
        f"({sweeps['s'] / svd:.1%}); the rest, {svd - sweeps['s']:.2f} s, "
        f"is the host float64 algebra and its copies")
    log(f"[phase 8] peak device memory above the start "
        f"{peak / 2**20:.1f} MiB ({torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB allocated at the peak)")
    log(f"[phase 8] kernel launches during the fit: {counts}")
    if rel > 1e-3:
        fail(f"the host-chunked fit's Ritz values are {rel:.3g} off the "
             "device fit's (limit 1e-3 relative)")
    if cos < 1 - 1e-3:
        fail(f"the host-chunked fit's embedding spans another subspace "
             f"(principal-angle cosine {cos:.6f})")
    if acc_dev < 0.99:
        fail(f"the host-chunked fit's labels agree with the same k-means "
             f"over the device fit's embedding at {acc_dev:.4f} < 0.99")
    max_iters = cfg.solver_options.iters
    if diag["solver_iterations"] >= max_iters:
        fail(f"the host-chunked LOBPCG solve ran to its cap of {max_iters} "
             "iterations")
    n_chunks = -(-n // STREAM_CHUNK)
    if counts["bin_counts"] != n_chunks:
        fail(f"{counts['bin_counts']} bin_counts launches, not one per chunk "
             f"({n_chunks})")
    missing = [k for k in STREAM_KERNELS if counts[k] <= 0]
    if missing or counts["gram_matmul"]:
        fail(f"the host-chunked fit launched no {missing} kernel, or the "
             f"fused Gram product ({counts['gram_matmul']} times)")
    if res.labels.shape != (n,) or not np.all(np.isfinite(res.embedding)):
        fail("the host-chunked fit's labels or embedding are malformed")

    # degrees: the same bits at another chunking
    chunks = streaming.chunked_rb_transform(
        streaming.as_row_chunks(x_np, STREAM_CHUNK), model.feature_map.params,
        device="cuda")
    whole = torch.cat(chunks)
    big_d, d_g = model.feature_map.n_features, model.feature_map.d_g
    deg = {c: streaming.chunked_degrees(streaming.as_row_chunks(whole, c),
                                        d=big_d, d_g=d_g, device="cuda")
           for c in (STREAM_CHUNK, 100_000)}
    same = torch.equal(deg[STREAM_CHUNK], deg[100_000])
    log(f"[phase 8] degrees at chunks of {STREAM_CHUNK} and 100,000 rows: "
        f"identical bits = {same}; max degree x R = "
        f"{float(deg[STREAM_CHUNK].max()) * cfg.n_grids:.4g} (2^24 = "
        f"{2 ** 24})")
    if not same or float(deg[STREAM_CHUNK].min()) != diag["degrees_min"]:
        fail("the streaming degrees depend on the chunking")
    del chunks, whole, deg

    # save → load → predict of the chunked model
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "chunked.npz")
        model.save(path)
        served = SCRBModel.load(path, device="cuda")
        pred = served.predict(x_np[:STREAM_PREDICT_ROWS])
    agree = metrics.accuracy(pred, res.labels[:STREAM_PREDICT_ROWS])
    log(f"[phase 8] save -> load -> predict of the chunked model on "
        f"{STREAM_PREDICT_ROWS} rows: agreement with its fit labels "
        f"{agree:.4f}")
    if agree < 0.99:
        fail(f"the chunked model's predict agrees at {agree:.4f} < 0.99")
    del model, served

    sweeps.update(n=0, s=0.0, bytes=0)
    half, wall_h, _, peak_h = fit(
        x_np[:STREAM_HALF],
        dataclasses.replace(cfg_c, solver_tol=STREAM_HALF_TOL))
    diag_h = half.fit_result.diagnostics
    log(f"[phase 8] host-chunked fit N={STREAM_HALF} in {wall_h:.2f}s "
        f"({diag_h['n_chunks']} chunks); stages (s): " + ", ".join(
            f"{k}={v:.3f}" for k, v in half.fit_result.timer.times.items())
        + f"; solver_iterations={diag_h['solver_iterations']} (cap "
        f"{max_iters}, tol {STREAM_HALF_TOL}) resnorms="
        f"{[float(f'{r:.3g}') for r in diag_h['solver_resnorms']]}; "
        f"{sweeps['n']} Gram sweeps, {sweeps['s']:.2f} s")
    log(f"[phase 8] peak device memory above the start at N={STREAM_HALF} "
        f"{peak_h / 2**20:.1f} MiB against {peak / 2**20:.1f} MiB at N={n} "
        f"(limit: within {STREAM_FLAT_BYTES / 2**20:.0f} MiB)")
    if diag_h["solver_iterations"] >= max_iters:
        fail(f"the host-chunked LOBPCG solve at N={STREAM_HALF} ran to its "
             f"cap of {max_iters} iterations")
    if abs(peak - peak_h) > STREAM_FLAT_BYTES:
        fail(f"the host-chunked fit's peak device memory moved by "
             f"{(peak - peak_h) / 2**20:.1f} MiB from N={STREAM_HALF} to "
             f"N={n}")
    return counts


def as_host(t):
    """A tall result (a tensor or host chunks) as a host numpy array."""
    if hasattr(t, "to_array"):
        return t.to_array()
    return t.detach().cpu().numpy()


def principal_sine(a, b, k: int) -> float:
    """Sine of the largest principal angle between the spans of the
    leading k columns of two (N, ≥ k) blocks."""
    cos = subspace_cosine(as_host(a)[:, :k], as_host(b)[:, :k])
    return float(max(0.0, 1.0 - min(cos, 1.0) ** 2) ** 0.5)


def with_solver(cfg, solver: str, **fields):
    """``cfg`` with another solver (and other fields), through its flat
    dict: ``dataclasses.replace(cfg, solver_options=...)`` would keep the
    flat ``solver`` mirror, which takes precedence."""
    from repro_torch.core import SCRBConfig
    return SCRBConfig.from_dict({**cfg.to_dict(), "solver": solver,
                                 **fields})


def timed_execute(x, cfg, **kw):
    """``executor.execute`` with its state, and its host seconds (device
    synchronised)."""
    import torch

    from repro_torch.core import executor
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = executor.execute(x, cfg, keep_state=True, device="cuda", **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def hold_solver(tag: str, res, wall: float, ref, counts: dict, cfg, *,
                gate_labels: bool = True) -> dict:
    """One solver's fit against a LOBPCG fit of the same rows. A solve that
    converged (reached tol, or ``auto``'s LOBPCG stopped by its stability
    test before the cap) is held to Ritz values within RITZ_RTOL relative,
    the leading K vectors within SINE_MAX and, with ``gate_labels``, labels
    by ARI ≥ SOLVER_ARI; any other to the Rayleigh–Ritz lower bound. The
    Gram product must have run."""
    import numpy as np

    from repro_torch.core import metrics
    k = cfg.n_clusters
    so = cfg.solver_options
    d = res.diagnostics
    theta = np.asarray(res.singular_values, np.float64) ** 2
    theta_ref = np.asarray(ref.singular_values, np.float64) ** 2
    rel = float(np.max(np.abs(theta - theta_ref) / theta_ref))
    resmax = float(np.max(d["solver_resnorms"]))
    reached = resmax <= so.tol
    stable = so.solver == "auto" and 3 < d["solver_iterations"] < so.iters + 3
    converged = reached or stable
    sine = principal_sine(res.state["eig"].vectors, ref.state["eig"].vectors,
                          k)
    ari = metrics.adjusted_rand_index(res.labels, ref.labels)
    row = {"solver": tag, "wall_s": wall, "stages": dict(res.timer.times),
           "iterations": d["solver_iterations"], "resnorm_max": resmax,
           "converged": converged, "ritz_rel": rel, "sine": sine, "ari": ari,
           "gram_launches": counts["gram_matmul"]
           + counts["gram_matmul_composed"]}
    log(f"[phase 9] {tag}: fit {wall:.3f}s, svd {res.timer.times['svd']:.3f}s,"
        f" {d['solver_iterations']} iterations, resnorm max {resmax:.3g} "
        f"(tol {so.tol:g}: reached={reached}, converged={converged}); Ritz "
        f"values {[float(f'{t:.6f}') for t in theta]}, max relative "
        f"difference from LOBPCG's {rel:.3g}; sine of the largest principal "
        f"angle {sine:.3g}; ARI against LOBPCG's labels {ari:.4f}"
        + (f" (bar {SOLVER_ARI})" if converged and gate_labels else "")
        + f"; Gram products {row['gram_launches']}")
    if row["gram_launches"] <= 0:
        fail(f"{tag} launched no Gram product")
    if not np.all(np.isfinite(theta)) or res.labels.shape != ref.labels.shape:
        fail(f"{tag}: malformed Ritz values or labels")
    if converged:
        if rel > RITZ_RTOL:
            fail(f"{tag} converged but its Ritz values are {rel:.3g} off "
                 f"LOBPCG's (limit {RITZ_RTOL:g} relative)")
        if sine > SINE_MAX:
            fail(f"{tag} converged but its leading {k} vectors are "
                 f"{sine:.3g} off LOBPCG's (sine limit {SINE_MAX:g})")
        if gate_labels and ari < SOLVER_ARI:
            fail(f"{tag} converged but its labels agree with LOBPCG's at ARI"
                 f" {ari:.4f} < {SOLVER_ARI}")
    elif np.any(theta > theta_ref * (1 + 1e-4)):
        # Rayleigh–Ritz: Ritz values of any subspace lie below the
        # eigenvalues they approximate
        fail(f"{tag}: a Ritz value lies above LOBPCG's converged one")
    return row


def device_busy(fn) -> dict:
    """The device's busy time over ``fn()`` from a ``torch.profiler`` trace
    (the union of its CUDA kernel, copy and set intervals), beside the host
    wall time of ``fn()`` run once without the profiler (device
    synchronised): their ratio is the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_events": len(spans), "busy_us": busy, "wall_us": wall_us}


def phase9_solvers(x_np, cfg, device_fit) -> dict:
    """Every other solver on the covtype-shaped data against a LOBPCG fit
    of the same rows; a traced fit; the device's busy share; the host-
    chunked randomized and auto on a row prefix."""
    import json

    import numpy as np
    import torch

    from repro_torch.core import SCRBModel, executor, metrics
    from repro_torch.kernels import ops

    out = {"solvers": [], "fits": {}}
    ref, ref_wall = timed_execute(x_np, cfg)
    same = np.array_equal(ref.labels, device_fit["labels"])
    log(f"[phase 9] LOBPCG as phase 3: fit {ref_wall:.3f}s, "
        f"{ref.diagnostics['solver_iterations']} iterations, labels "
        f"identical to phase 3's = {same}")
    n = x_np.shape[0]
    x0 = torch.randn((n, EIG_BLOCK), generator=torch.Generator().manual_seed(1))
    plan = dataclasses.replace(executor.plan_from_config(cfg), eig_x0=x0)
    other, other_wall = timed_execute(x_np, cfg, plan=plan)
    out["lobpcg_other_start"] = hold_solver(
        "lobpcg (another start block)", other, other_wall, ref,
        {"gram_matmul": 1, "gram_matmul_composed": 0}, cfg)
    del other
    for solver in SOLVERS:
        cfg_s = with_solver(cfg, solver)
        ops.reset_launch_counts()
        res, wall = timed_execute(x_np, cfg_s)
        counts = ops.launch_counts()
        out["solvers"].append(hold_solver(solver, res, wall, ref, counts,
                                          cfg_s))
        out["fits"][solver] = single_summary(res, wall)
        del res
        torch.cuda.empty_cache()

    # a traced fit beside an untraced one; the trace's spans and memory
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "fit_trace.json")
        walls = {}
        for name, c in (("untraced", cfg),
                        ("traced", dataclasses.replace(cfg, trace=path))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = SCRBModel.fit(x_np, c)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        with open(path) as f:
            doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    mem = model.fit_result.diagnostics["memory"]
    root = next(e for e in spans if e["name"] == "fit")
    stage_us = {e["name"]: e["dur"] for e in spans
                if e["name"] in TRACE_SPANS[1:]}
    gaps = root["dur"] - sum(stage_us[s] for s in TRACE_SPANS[1:6]
                             if s in stage_us)
    out["trace"] = {"untraced_s": walls["untraced"],
                    "traced_s": walls["traced"], "spans": sorted(names),
                    "span_ms": {s: v / 1e3 for s, v in stage_us.items()},
                    "fit_ms": root["dur"] / 1e3, "between_stages_ms":
                    gaps / 1e3, "memory": mem}
    log(f"[phase 9] fit untraced {walls['untraced']:.3f}s, traced "
        f"{walls['traced']:.3f}s; trace spans {sorted(names)}; fit span "
        f"{root['dur'] / 1e3:.1f} ms: " + ", ".join(
            f"{s} {v / 1e3:.1f}" for s, v in stage_us.items())
        + f" ms, {gaps / 1e3:.1f} ms outside the five stages; memory "
        f"{mem}")
    missing = [s for s in TRACE_SPANS if s not in names]
    if missing:
        fail(f"the traced fit's Chrome trace lacks the spans {missing}")
    if mem.get("device_bytes_in_use") is None \
            or mem.get("device_peak_bytes") is None:
        fail(f"diagnostics['memory'] holds no device numbers: {mem}")
    del model

    busy = device_busy(lambda: SCRBModel.fit(x_np, cfg))
    out["busy"] = busy
    if busy["device_events"]:
        log(f"[phase 9] torch.profiler over one fit: {busy['device_events']}"
            f" device events, busy {busy['busy_us'] / 1e3:.1f} ms; the same "
            f"fit without the profiler {busy['wall_us'] / 1e3:.1f} ms: "
            f"device idle share {1 - busy['busy_us'] / busy['wall_us']:.3f}")
    else:
        log("[phase 9] torch.profiler recorded no device events: the idle "
            "share is not measured")

    # the host-chunked randomized and auto on a row prefix
    xp = x_np[:CHUNKED_PREFIX]
    pref, _ = timed_execute(xp, cfg)
    log(f"[phase 9] host-chunked solvers on the first {CHUNKED_PREFIX} rows "
        f"(a cut of N = {n}), chunks of {CHUNKED_CHUNK}, against a device "
        f"LOBPCG fit of the same rows ({pref.diagnostics['solver_iterations']}"
        f" iterations)")
    out["chunked"] = []
    for solver in CHUNKED_SOLVERS:
        cfg_c = with_solver(cfg, solver, chunk_size=CHUNKED_CHUNK)
        ops.reset_launch_counts()
        res, wall = timed_execute(xp, cfg_c)
        counts = ops.launch_counts()
        counts["gram_matmul"] = counts["zt_matmul"]   # a zt sweep, then z
        # host chunks cluster with streaming_kmeans, not Lloyd: labels are
        # printed, not held to the device fit's (PERF.md §6)
        out["chunked"].append(hold_solver(f"{solver} on host chunks", res,
                                          wall, pref, counts, cfg_c,
                                          gate_labels=False))
        if res.diagnostics["plan"]["residency"] != "host_chunked":
            fail(f"the chunked {solver} fit ran on device rows")
    return out


def phase10_kernels(x, fm) -> list:
    """The kernels at the widths the compressive cell gives them,
    on the poker-shaped pattern: the Gram product bit-equal to zt then z
    and within the sum tolerance of its plain version at K = 1, 14, 32;
    zt and z at the projection's width d = 14;
    kmeans_assign and its statistics form exact at d = 14, K = 10 (small
    integer values: every distance is exact)."""
    import torch

    from repro_torch.core import graph
    from repro_torch.kernels import ops, ref

    dev = x.device
    p = fm.params
    n, r, d_g, big_d = x.shape[0], p.n_grids, p.d_g, p.n_features
    g = torch.Generator(device=dev).manual_seed(10)
    idx = ops.rb_binning(x, p.widths, p.biases, p.hash_a, p.hash_c, d_g=d_g)
    adj = graph.build_normalized_adjacency(idx, d=big_d, d_g=d_g)
    s, csc = adj.rowscale, adj.csc
    rows = []
    for kk in GRAM_WIDTHS:
        if ops.z_strip_plan(n, r, d_g, kk, torch.float32) is None:
            fail(f"the Gram product at K = {kk} has no strip route")
        u = torch.randn((n, kk), generator=g, device=dev)
        ops.reset_launch_counts()
        got = ops.gram_matmul(idx, u, s, big_d, d_g=d_g, csc=csc)
        fused = ops.launch_counts()["gram_matmul"] == 1
        composed = lambda: ops.z_matmul(
            idx, ops.zt_matmul(idx, u, s, big_d, d_g=d_g, csc=csc), s,
            d_g=d_g)
        want = composed()
        if not fused or not torch.equal(got, want):
            fail(f"the Gram product at K = {kk} differs from zt_matmul then "
                 f"z_matmul in {int((got != want).sum())} entries (fused "
                 f"kernel used: {fused})")
        # and against the plain version, at this width's column groups
        plain = ref.z_matmul_ref(idx, ref.zt_matmul_ref(idx, u, s, big_d), s)
        terms = ref.z_matmul_ref(
            idx, ref.zt_matmul_ref(idx, u.abs(), s.abs(), big_d), s.abs())
        ok, err = within_sum_tolerance(got, plain, terms)
        if not ok:
            fail(f"the Gram product at K = {kk} differs from its plain "
                 f"version (max abs {err:.3g})")
        del plain, terms
        b_ms, b_by = bound(*ops.gram_matmul_cost(n, r, big_d, kk))
        ms = time_ms(lambda: ops.gram_matmul(idx, u, s, big_d, d_g=d_g,
                                             csc=csc))
        c_ms = time_ms(composed)
        plain_ms = time_ms(lambda: ref.z_matmul_ref(
            idx, ref.zt_matmul_ref(idx, u, s, big_d), s), iters=2, warmup=1)
        rows.append({"kernel": "gram_matmul", "k": kk, "ms": ms,
                     "composed_ms": c_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err, "plain_ms": plain_ms})
        log(f"[phase 10] gram_matmul K={kk}: fused {ms:.4f} ms, zt then z "
            f"{c_ms:.4f} ms (the same bits; within the sum tolerance of the "
            f"plain version, max abs {err:.3g}); bound {b_ms:.4f} ms "
            f"({b_by}); plain version {plain_ms:.4f} ms")
        del u, got, want
    kd = KMEANS_D
    u = torch.randn((n, kd), generator=g, device=dev)
    v = torch.randn((big_d, kd), generator=g, device=dev)
    got = ops.zt_matmul(idx, u, s, big_d, d_g=d_g, csc=csc)
    ok, err = within_sum_tolerance(got, ref.zt_matmul_ref(idx, u, s, big_d),
                                   ref.zt_matmul_ref(idx, u.abs(), s.abs(),
                                                     big_d))
    if not ok:
        fail(f"zt_matmul at K = {kd} differs from its plain version "
             f"(max abs {err:.3g})")
    b_ms, b_by = bound(*ops.zt_matmul_cost(n, r, big_d, kd))
    ms = time_ms(lambda: ops.zt_matmul(idx, u, s, big_d, d_g=d_g, csc=csc))
    plain_ms = time_ms(lambda: ref.zt_matmul_ref(idx, u, s, big_d), iters=2,
                       warmup=1)
    src_rows = (u * s[:, None]).repeat_interleave(r, dim=0)
    flat = idx.reshape(-1)
    lib_ms = time_ms(lambda: torch.zeros((big_d, kd), device=dev).index_add_(
        0, flat, src_rows), iters=3, warmup=1)
    del src_rows, flat
    rows.append({"kernel": "zt_matmul", "k": kd, "ms": ms, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err, "plain_ms": plain_ms,
                 "library_ms": lib_ms})
    got = ops.z_matmul(idx, v, s, d_g=d_g)
    ok, err = within_sum_tolerance(got, ref.z_matmul_ref(idx, v, s),
                                   ref.z_matmul_ref(idx, v.abs(), s.abs()))
    if not ok:
        fail(f"z_matmul at K = {kd} differs from its plain version "
             f"(max abs {err:.3g})")
    b_ms, b_by = bound(*ops.z_matmul_cost(n, r, big_d, kd))
    ms = time_ms(lambda: ops.z_matmul(idx, v, s, d_g=d_g))
    plain_ms = time_ms(lambda: ref.z_matmul_ref(idx, v, s), iters=2,
                       warmup=1)
    w_bag = s[:, None].expand(n, r).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        idx, v, mode="sum", per_sample_weights=w_bag))
    del w_bag
    rows.append({"kernel": "z_matmul", "k": kd, "ms": ms, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err, "plain_ms": plain_ms,
                 "library_ms": lib_ms})
    zt_row = rows[-2]
    log(f"[phase 10] zt_matmul K={kd}: {zt_row['ms']:.4f} ms (bound "
        f"{zt_row['bound_ms']:.4f}, plain {zt_row['plain_ms']:.4f}, "
        f"index_add_ {zt_row['library_ms']:.4f}); z_matmul K={kd}: "
        f"{ms:.4f} ms (bound {b_ms:.4f}, plain {plain_ms:.4f}, embedding_bag "
        f"{lib_ms:.4f}); both within the sum tolerance of their plain "
        "versions")
    del u, v, got, adj, csc, idx
    torch.cuda.empty_cache()

    emb = torch.randint(-3, 4, (n, kd), generator=g, device=dev).float()
    cents = torch.randint(-3, 4, (KMEANS_K, kd), generator=g,
                          device=dev).float()
    lab, dist = ops.kmeans_assign(emb, cents)
    lab_p, dist_p = ref.kmeans_assign_ref(emb, cents)
    if not (torch.equal(lab, lab_p) and torch.equal(dist, dist_p)):
        fail(f"kmeans_assign at d = {kd}, K = {KMEANS_K} differs from its "
             f"plain version: {int((lab != lab_p).sum())} labels, max "
             f"distance error {float((dist - dist_p).abs().max()):.3g}")
    lab_s, counts, _, _ = ops.kmeans_assign_stats(emb, cents)
    if not torch.equal(lab_s, lab) or not torch.equal(
            counts, torch.bincount(lab, minlength=KMEANS_K).float()):
        fail(f"kmeans_assign_stats at d = {kd}, K = {KMEANS_K}: labels or "
             "counts differ")
    kms, _ = time_device(lambda: ops.kmeans_assign(emb, cents))
    sms, _ = time_device(lambda: ops.kmeans_assign_stats(emb, cents))
    b_ms, b_by = bound(n * kd * 4 + KMEANS_K * kd * 4 + n * 8,
                       3.0 * n * kd * KMEANS_K)
    rows.append({"kernel": "kmeans_assign", "k": KMEANS_K, "d": kd,
                 "ms": kms, "bound_ms": b_ms, "bound_by": b_by})
    e_len = KMEANS_K * (kd + 1) + 1
    b2, b2_by = bound(n * kd * 4 + KMEANS_K * kd * 4 + n * 4 + e_len * 4,
                      3.0 * n * kd * KMEANS_K + n * (kd + 1))
    rows.append({"kernel": "kmeans_assign_stats", "k": KMEANS_K, "d": kd,
                 "ms": sms, "bound_ms": b2, "bound_by": b2_by})
    log(f"[phase 10] kmeans_assign d={kd} K={KMEANS_K}: labels and distances"
        f" exact; {kms:.4f} ms on the device (bound {b_ms:.4f}); "
        f"kmeans_assign_stats: labels and counts exact, {sms:.4f} ms (bound "
        f"{b2:.4f})")
    return rows


def phase10_compressive() -> dict:
    """The compressive cell at the paper's poker size: solver="auto" on
    1,025,010 rows routes to it, on device rows and on host chunks. Its
    cold eigencount is printed beside LOBPCG's θ_K and θ_K+1 (at this N the
    damped step's response at 0 times the null space moves the count:
    ROADMAP.md C5); the cell with LOBPCG's bracket is held to LOBPCG's
    labels, on device rows and host chunks."""
    import numpy as np
    import torch

    from repro_torch.core import (
        RBMap, SCRBConfig, SCRBModel, SolverOptions, compressive,
        eigensolver, metrics,
    )
    from repro_torch.core.rb import suggest_sigma
    from repro_torch.core.rowmatrix import _solver_precond
    from repro_torch.data.synthetic import SuiteSpec, generate
    from repro_torch.kernels import ops
    from repro_torch.utils import fold_seed, make_generator

    t0 = time.perf_counter()
    x_np, y_np = generate(SuiteSpec(*POKER), scale=1.0, seed=0)
    n, k = x_np.shape[0], POKER[1]
    sigma = suggest_sigma(x_np)
    cfg = SCRBConfig(n_clusters=k, n_grids=N_GRIDS, sigma=sigma,
                     solver_options=SolverOptions(solver="auto"))
    log(f"[phase 10] poker-shaped synthetic N={n} d={x_np.shape[1]} K={k} "
        f"R={N_GRIDS}, sigma={sigma:.6g}, made in "
        f"{time.perf_counter() - t0:.1f}s (not cut)")
    out = {}
    x_dev = torch.as_tensor(x_np, device="cuda")
    fm = RBMap(n_grids=N_GRIDS, sigma=sigma).fit(cfg.seed, x_dev)
    out["kernels"] = phase10_kernels(x_dev, fm)
    del x_dev, fm
    torch.cuda.empty_cache()

    def fit(x, c):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        model = SCRBModel.fit(x, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (model, wall, ops.launch_counts(),
                torch.cuda.max_memory_allocated() - base)

    model, wall, counts, peak = fit(x_np, cfg)
    res = model.fit_result
    d = res.diagnostics
    if d["solver"] != "compressive":
        fail(f"solver='auto' at N={n} ran {d['solver']!r}, not compressive")
    comp = d["compressive"]
    log(f"[phase 10] SCRBModel.fit(solver='auto') on the card: solver "
        f"{d['solver']}, {wall:.3f}s; stages (s): " + ", ".join(
            f"{s}={v:.3f}" for s, v in res.timer.times.items())
        + f"; {d['solver_iterations']} Gram products ({comp}); d_g "
        f"{d['d_g']}, D {d['n_features_D']}; Ritz singular values "
        f"{[float(f'{v:.5f}') for v in res.singular_values]}; peak device "
        f"memory above the start {peak / 2**20:.1f} MiB; k-means on "
        f"{d['kmeans_subset_rows']} rows")
    log(f"[phase 10] kernel launches during the compressive fit: {counts}")
    log(f"[phase 10] ACC={metrics.accuracy(res.labels, y_np):.4f} "
        f"NMI={metrics.nmi(res.labels, y_np):.4f} against the synthetic "
        "truth (for information)")
    missing = [kname for kname in COMPRESSIVE_KERNELS if counts[kname] <= 0]
    if missing:
        fail(f"the compressive fit launched no {missing} kernel")
    if res.labels.shape != (n,) or not np.all(np.isfinite(res.embedding)):
        fail("the compressive fit's labels or embedding are malformed")
    out["device"] = {"wall_s": wall, "stages": dict(res.timer.times),
                     "iterations": d["solver_iterations"],
                     "compressive": comp, "peak_bytes": peak,
                     "launches": counts}

    again, wall2, _, _ = fit(x_np, cfg)
    same = np.array_equal(again.fit_result.labels, res.labels)
    log(f"[phase 10] a second compressive fit ({wall2:.3f}s, svd "
        f"{again.fit_result.timer.times['svd']:.3f}s): labels identical = "
        f"{same}")
    out["device"]["wall2_s"] = wall2
    if not same:
        fail("two compressive fits of the same data differ in "
             f"{int((again.fit_result.labels != res.labels).sum())} labels")
    del again

    t0 = time.perf_counter()
    pred = model.predict(x_np)
    dt = time.perf_counter() - t0
    agree = metrics.accuracy(pred, res.labels)
    log(f"[phase 10] predict on the {n} training rows: {dt:.3f}s, agreement "
        f"with the fit labels {agree:.6f} (limit {PREDICT_AGREE})")
    if agree < PREDICT_AGREE:
        fail(f"predict on the training rows agrees at {agree:.6f} < "
             f"{PREDICT_AGREE}")

    # LOBPCG on the same data: its labels, and θ_K, θ_{K+1} for the cutoff
    cfg_l = with_solver(cfg, "lobpcg")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lres, lwall = timed_execute(x_np, cfg_l)
    lpeak = torch.cuda.max_memory_allocated() - base
    z = lres.state["z"]
    so = cfg_l.solver_options
    eig = eigensolver.top_k_eigenpairs(
        z.gram, z.n, k + 1, make_generator(1), device=z.device,
        max_iters=so.iters, tol=so.tol, buffer=so.buffer,
        precond=_solver_precond(cfg_l, z.adj.deg))
    theta = eig.theta.cpu().numpy().astype(np.float64)
    ari = metrics.adjusted_rand_index(res.labels, lres.labels)
    # the eigencount behind the cutoff, from the fit's own probe block: the
    # smoothed count at the true θ_K, and the share of it that the null
    # space (at least N − D eigenvalues at 0) adds through the damped step
    est, _ = compressive.estimate_lambda_k(
        z, k, fold_seed(fold_seed(cfg.seed, "eig"), "count"))
    at_k = compressive.eigencount(est.moments, est.probes, theta[k - 1])
    h0 = float(compressive.step_eval(
        compressive.step_coeffs(theta[k - 1], est.degree), 0.0))
    null_dim = max(n - d["n_features_D"], 0)      # rank(Â) ≤ D
    null = null_dim * h0
    log(f"[phase 10] LOBPCG on the same data: fit {lwall:.3f}s (svd "
        f"{lres.timer.times['svd']:.3f}s, {lres.diagnostics['solver_iterations']}"
        f" iterations, peak device memory above the start "
        f"{lpeak / 2**20:.1f} MiB) against the cold compressive fit's "
        f"{wall:.3f}s (svd {res.timer.times['svd']:.3f}s); theta_K="
        f"{theta[k - 1]:.6f}, theta_K+1={theta[k]:.6f} ({eig.iterations} "
        f"iterations); the cold cutoff {comp['cutoff']:.6f} "
        f"(in [theta_K+1, theta_K]: "
        f"{bool(theta[k] <= comp['cutoff'] <= theta[k - 1])}); labels "
        f"against LOBPCG's: ARI {ari:.4f}")
    log(f"[phase 10] the eigencount at theta_K={theta[k - 1]:.6f} from the "
        f"same {est.probes} probes: {at_k:.2f} eigenvalues (K = {k}); the "
        f"damped step there is h(0) = {h0:.3g} at 0, so the at least "
        f"{null_dim} null eigenvalues (N - D) add "
        f"{null:.2f} to it; the count's cutoff {est.cutoff:.6f} (the fit's "
        f"{comp['cutoff']:.6f})")
    out["lobpcg"] = {"wall_s": lwall, "svd_s": lres.timer.times["svd"],
                     "iterations": lres.diagnostics["solver_iterations"],
                     "peak_bytes": lpeak, "theta": theta.tolist(),
                     "ari_cold": ari, "count_at_theta_k": at_k,
                     "null_share": null}
    if est.cutoff != comp["cutoff"]:
        fail(f"the eigencount from the fit's probes gives the cutoff "
             f"{est.cutoff!r}, the fit {comp['cutoff']!r}")
    lobpcg_labels, bracket = lres.labels, [theta[k - 1], theta[k]]
    del lres, z, eig, model, res
    torch.cuda.empty_cache()

    # the cell with LOBPCG's bracket (CompressiveOptions.lambdas, the
    # reference's warm start): the filter, projection and subset k-means
    # at full N, held to LOBPCG's labels
    cfg_w = with_solver(cfg, "compressive", compressive_lambdas=bracket)
    warm, wwall, _, wpeak = fit(x_np, cfg_w)
    wres = warm.fit_result
    wd = wres.diagnostics
    wari = metrics.adjusted_rand_index(wres.labels, lobpcg_labels)
    wpred = metrics.accuracy(warm.predict(x_np), wres.labels)
    log(f"[phase 10] the compressive cell with LOBPCG's bracket: {wwall:.3f}s;"
        f" stages (s): " + ", ".join(
            f"{s}={v:.3f}" for s, v in wres.timer.times.items())
        + f"; {wd['solver_iterations']} Gram products ({wd['compressive']}); "
        f"Ritz singular values "
        f"{[float(f'{v:.5f}') for v in wres.singular_values]}; peak device "
        f"memory above the start {wpeak / 2**20:.1f} MiB; labels against "
        f"LOBPCG's: ARI {wari:.4f} (bar {COMPRESSIVE_ARI}); ACC "
        f"{metrics.accuracy(wres.labels, y_np):.4f} against the truth; "
        f"predict on the training rows agrees {wpred:.6f}")
    out["warm"] = {"wall_s": wwall, "stages": dict(wres.timer.times),
                   "iterations": wd["solver_iterations"],
                   "compressive": wd["compressive"], "peak_bytes": wpeak,
                   "ari": wari}
    if wari < COMPRESSIVE_ARI:
        fail(f"the compressive cell with LOBPCG's bracket agrees with "
             f"LOBPCG's labels at ARI {wari:.4f} < {COMPRESSIVE_ARI}")
    if wpred < PREDICT_AGREE:
        fail(f"predict of the bracketed compressive model agrees at "
             f"{wpred:.6f} < {PREDICT_AGREE}")
    warm_labels = wres.labels
    del warm, wres

    # host chunks: solver="auto" routes there too; the bracketed cell at N
    # and N/2 (named: auto takes LOBPCG below 10^6 rows) for the labels and
    # the peak memory
    cfg_c = dataclasses.replace(cfg, chunk_size=POKER_CHUNK)
    cold_c, cwall, ccounts, cpeak = fit(x_np, cfg_c)
    cd = cold_c.fit_result.diagnostics
    cold_stages = dict(cold_c.fit_result.timer.times)
    log(f"[phase 10] host-chunked solver='auto', chunk_size={POKER_CHUNK} "
        f"({cd['n_chunks']} chunks): solver {cd['solver']}, {cwall:.2f}s; "
        f"stages (s): " + ", ".join(
            f"{s}={v:.3f}" for s, v in cold_stages.items())
        + f"; {cd['solver_iterations']} Gram sweeps; cutoff "
        f"{cd['compressive']['cutoff']:.6f}; peak device memory above the "
        f"start {cpeak / 2**20:.1f} MiB")
    log(f"[phase 10] kernel launches during the host-chunked fit: {ccounts}")
    if cd["solver"] != "compressive" or cd["plan"]["residency"] \
            != "host_chunked":
        fail("the chunked solver='auto' fit did not run the host-chunked "
             "compressive cell")
    if ccounts["gram_matmul"] or not ccounts["zt_matmul"] \
            or not ccounts["bin_counts"]:
        fail("the host-chunked compressive fit ran the fused Gram product, "
             "or no zt sweep or bin_counts")
    del cold_c
    cfg_cw = dataclasses.replace(cfg_w, chunk_size=POKER_CHUNK)
    chunked, cwwall, _, cwpeak = fit(x_np, cfg_cw)
    cari = metrics.adjusted_rand_index(chunked.fit_result.labels, warm_labels)
    del chunked
    half, hwall, _, hpeak = fit(x_np[:n // 2], cfg_cw)
    log(f"[phase 10] host-chunked compressive cell with LOBPCG's bracket: "
        f"N={n} {cwwall:.2f}s, labels against the device cell's ARI "
        f"{cari:.4f} (bar {COMPRESSIVE_ARI}); N={n // 2} {hwall:.2f}s "
        f"(solver {half.fit_result.diagnostics['solver']}); peak device "
        f"memory above the start {hpeak / 2**20:.1f} MiB at N={n // 2}, "
        f"{cwpeak / 2**20:.1f} MiB at N={n} (limit: within "
        f"{STREAM_FLAT_BYTES / 2**20:.0f} MiB)")
    if cari < COMPRESSIVE_ARI:
        fail(f"the host-chunked compressive labels agree with the device "
             f"cell's at ARI {cari:.4f} < {COMPRESSIVE_ARI}")
    if abs(cwpeak - hpeak) > STREAM_FLAT_BYTES:
        fail(f"the host-chunked compressive fit's peak device memory moved by"
             f" {(cwpeak - hpeak) / 2**20:.1f} MiB from N={n // 2} to N={n}")
    out["chunked"] = {"cold_wall_s": cwall, "cold_stages": cold_stages,
                      "wall_s": cwwall, "peak_bytes": cwpeak,
                      "half_wall_s": hwall, "half_peak_bytes": hpeak,
                      "ari": cari}
    return out


def dense_transform_gate(tag: str, fm, rows_np) -> float:
    """A fitted dense map's transform on the card against the same map on
    the CPU: within DENSE_TOL; for LSC, a row whose kept anchors differ must
    have its s-th and (s+1)-th largest affinities within DENSE_TOL
    relative (a near-tie the two devices' rounding may break either way),
    and the other rows are held to DENSE_TOL."""
    import torch

    from repro_torch.core.nystrom import pairwise_kernel

    got = fm.transform(torch.as_tensor(rows_np, device="cuda")).cpu()
    cpu = fm.to("cpu")
    xs = torch.from_numpy(rows_np)
    want = cpu.transform(xs)
    keep = torch.ones(rows_np.shape[0], dtype=torch.bool)
    if fm.name == "lsc":
        keep = ((got > 0) == (want > 0)).all(1)
        bad = torch.nonzero(~keep).reshape(-1)
        if bad.numel():
            aff = pairwise_kernel(xs[bad], cpu.anchors, cpu.sigma,
                                  cpu.kernel)
            s = min(cpu.n_nearest, cpu.anchors.shape[0])
            top = torch.topk(aff, s + 1, dim=-1).values
            gap = (top[:, s - 1] - top[:, s]) / top[:, s - 1]
            if bool((gap > DENSE_TOL).any()):
                fail(f"{tag}: {int((gap > DENSE_TOL).sum())} rows keep other "
                     "anchors on the card than on the CPU without a near-tie")
        log(f"[phase 11] {tag}: {int((~keep).sum())} of {keep.numel()} rows "
            "keep other anchors than on the CPU, each on a near-tie")
    err = float((got[keep] - want[keep]).abs().max())
    if err > DENSE_TOL:
        fail(f"{tag}: the transform on the card differs from the CPU's by "
             f"{err:.3g} > {DENSE_TOL}")
    return err


def phase11_baselines(x_np, y_np, sigma: float) -> dict:
    """The Table-2 methods on the covtype-shaped data; returns the sc_nys
    model for phase 12."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import (
        SCRBModel, baselines, executor, featuremap, metrics, streaming,
    )
    from repro_torch.core.kmeans import streaming_kmeans
    from repro_torch.utils import fold_seed, make_generator

    k = COVTYPE[1]
    cfg = baselines.BaselineConfig(n_clusters=k, rank=BASELINE_RANK,
                                   sigma=sigma, seed=0)
    scfg = baselines._scrb_config(cfg)
    out = {"methods": {}}
    labels = {}

    def run(name, xs):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = baselines.METHODS[name](xs, cfg)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() - base

    for name in baselines.METHODS:
        xs, ys = (x_np[:EXACT_SC_ROWS], y_np[:EXACT_SC_ROWS]) \
            if name == "sc" else (x_np, y_np)
        res, wall, peak = run(name, xs)
        labels[name] = res.labels
        acc = metrics.accuracy(res.labels, ys)
        ari = metrics.adjusted_rand_index(res.labels, ys)
        out["methods"][name] = {"s": wall, "acc": acc, "ari": ari,
                                "peak_mib": peak / 2**20,
                                "stages": dict(res.timer.times)}
        log(f"[phase 11] {name} N={xs.shape[0]}: {wall:.3f}s ("
            + ", ".join(f"{s}={v:.3f}" for s, v in res.timer.times.items())
            + f"); ACC={acc:.4f} ARI={ari:.4f} against the planted labels; "
            f"peak {peak / 2**20:.1f} MiB above the start")

    x_dev = torch.as_tensor(x_np, device="cuda")
    rows = x_np[:DENSE_ROWS]
    nys_model = None
    for name, fm_name, lap in PREDICT_METHODS:
        fm = featuremap.make_feature_map(fm_name, rank=BASELINE_RANK,
                                         sigma=sigma)
        plan = executor.ExecutionPlan(feature_map=fm,
                                      laplacian_normalize=lap)
        t0 = time.perf_counter()
        model = SCRBModel.fit(x_dev, scfg, plan=plan)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_labels = model.fit_result.labels
        same = bool(np.array_equal(fit_labels, labels[name]))
        t0 = time.perf_counter()
        pred = model.predict(x_np)
        pred_s = time.perf_counter() - t0
        agree = metrics.accuracy(pred, fit_labels)
        diag = model.fit_result.diagnostics
        log(f"[phase 11] {name} SCRBModel.fit {fit_s:.3f}s "
            f"(iterations {diag['solver_iterations']}, degrees "
            f"[{diag['degrees_min']:.4g}, {diag['degrees_max']:.4g}], labels "
            f"the METHODS run's: {same}); predict on the {x_np.shape[0]} "
            f"training rows {pred_s:.3f}s, agreement with the fit labels "
            f"{agree:.4f} (limit 0.99)")
        if agree < 0.99:
            fail(f"{name}: predict agrees with the fit labels at "
                 f"{agree:.4f} < 0.99")
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "model.npz")
            model.save(path)
            loaded = SCRBModel.load(path, device="cuda")
        if not (np.array_equal(loaded.predict(rows), model.predict(rows))
                and np.array_equal(loaded.transform(rows),
                                   model.transform(rows))):
            fail(f"{name}: save → load → predict/transform is not "
                 "bit-identical")
        if fm_name != "rff" or lap:          # one transform gate per map
            err = dense_transform_gate(f"{fm_name} transform",
                                       model.feature_map, rows)
            log(f"[phase 11] {fm_name} transform of {DENSE_ROWS} rows: max "
                f"abs {err:.3g} from the CPU's (limit {DENSE_TOL})")
        if name == "sc_nys":
            nys_model = model
        del model, loaded
    del x_dev

    xs = x_np[:DENSE_ROWS]
    for name in baselines.METHODS:
        part = xs[:EXACT_SC_ROWS] if name == "sc" else xs
        a = baselines.METHODS[name](part, cfg).labels
        b = baselines.METHODS[name](part, cfg).labels
        if not np.array_equal(a, b):
            fail(f"{name}: two runs on {part.shape[0]} rows differ in "
                 f"{int((a != b).sum())} labels")
    log(f"[phase 11] two runs of each method on {DENSE_ROWS} rows (sc "
        f"{EXACT_SC_ROWS}): the same labels")

    xs = x_np[:BASELINE_CHUNK_ROWS]
    fm = featuremap.make_feature_map("rff", rank=BASELINE_RANK, sigma=sigma)
    plan = executor.ExecutionPlan(feature_map=fm)
    t0 = time.perf_counter()
    dev = executor.execute(xs, scfg, plan)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked = executor.execute(xs, scfg, dataclasses.replace(
        plan, residency="host_chunked", chunk_size=BASELINE_CHUNK))
    ch_s = time.perf_counter() - t0
    steps = chunked.diagnostics["kmeans_steps"]
    same_alg = streaming_kmeans(
        make_generator(fold_seed(cfg.seed, "kmeans"), "cuda"),
        streaming.ChunkedDense.from_array(dev.embedding, BASELINE_CHUNK),
        k, n_steps=steps, n_replicates=cfg.kmeans_replicates, device="cuda")
    ari = metrics.adjusted_rand_index(chunked.labels,
                                      same_alg.labels.numpy())
    ari_lloyd = metrics.adjusted_rand_index(chunked.labels, dev.labels)
    theta_c = np.asarray(chunked.singular_values, np.float64) ** 2
    theta_d = np.asarray(dev.singular_values, np.float64) ** 2
    log(f"[phase 11] sc_rf host-chunked on {xs.shape[0]} rows (chunks of "
        f"{BASELINE_CHUNK}) {ch_s:.2f}s ("
        + ", ".join(f"{s}={v:.3f}" for s, v in chunked.timer.times.items())
        + f"), device {dev_s:.2f}s; iterations "
        f"{chunked.diagnostics['solver_iterations']} and "
        f"{dev.diagnostics['solver_iterations']}; Ritz values max relative "
        f"difference {float(np.max(np.abs(theta_c - theta_d) / theta_d)):.3g}"
        f"; ARI {ari:.4f} against the same streaming k-means over the device "
        f"fit's embedding (limit 0.99), {ari_lloyd:.4f} against the device "
        "fit's Lloyd labels (not gated: mini-batch against Lloyd k-means)")
    if ari < 0.99:
        fail(f"the host-chunked sc_rf fit agrees with the device one at ARI "
             f"{ari:.4f} < 0.99")
    out["chunked"] = {"s": ch_s, "device_s": dev_s, "ari": ari,
                      "ari_lloyd": ari_lloyd}
    out["nys_model"] = nys_model
    return out


def phase12_engine(models: dict, x_np) -> dict:
    """The predict serving engine on CUDA graphs, with ``models`` (name →
    fitted SCRBModel on the card)."""
    import json as _json
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.cluster_engine import (
        MODES, ClusterEngine, EngineConfig,
    )
    from repro_torch.serve.server import ClusterServer

    n = x_np.shape[0]
    ops.reset_launch_counts()
    eng = ClusterEngine(EngineConfig(buckets=ENGINE_BUCKETS))
    t0 = time.perf_counter()
    for name, mdl in models.items():
        eng.load_model(name, mdl)
        eng.warmup(name, modes=MODES)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = ops.launch_counts()          # the eager warm-ups and captures
    expect = len(models) * len(ENGINE_BUCKETS) * len(MODES)
    log(f"[phase 12] warmup of {list(models)}: {eng.total_compiles} graphs "
        f"captured in {warm_s:.2f}s (models × buckets × modes = {expect})")
    if eng.total_compiles != expect:
        fail(f"{eng.total_compiles} cells after warmup, not {expect}")
    rng = np.random.default_rng(12)
    names = list(models)
    # graph replays of the RB model's cells by bucket (both modes: each
    # replays the degrees' and the projection's gather once)
    rb_slot = eng._resident[names[0]].slot.id
    bucket_of = {id(c): b for (sid, b, _), c in eng._cells.items()
                 if sid == rb_slot}
    rb_replays = dict.fromkeys(ENGINE_BUCKETS, 0)
    run = eng._run

    def counted_run(cell, buf, out):
        if id(cell) in bucket_of:
            rb_replays[bucket_of[id(cell)]] += 1
        run(cell, buf, out)

    eng._run = counted_run

    def wave():
        reqs = []
        for _ in range(ENGINE_REQUESTS):
            rows = int(rng.integers(1, ENGINE_MAX_ROWS + 1))
            a = int(rng.integers(0, n - rows))
            reqs.append((names[int(rng.integers(len(names)))],
                         MODES[int(rng.integers(len(MODES)))], a, a + rows))
        before = state()
        t0 = time.perf_counter()
        tickets = [eng.submit(m, x_np[a:b], mode) for m, mode, a, b in reqs]
        eng.drain()
        wall = time.perf_counter() - t0
        after = state()
        got = [eng.take(t).values for t in tickets]
        t0 = time.perf_counter()
        want = [getattr(models[m], mode)(x_np[a:b])
                for m, mode, a, b in reqs]
        direct = time.perf_counter() - t0
        for (m, mode, a, b), g, w in zip(reqs, got, want):
            if not np.array_equal(g, w):
                fail(f"engine {mode} of {m} rows {a}:{b} is not bit-identical "
                     "to the model's")
        return sum(b - a for _, _, a, b in reqs), wall, direct, before, after

    def state():
        torch.cuda.synchronize()
        return (eng.total_compiles, eng.stats()["staging_allocations"],
                torch.cuda.memory_stats()["allocation.all.allocated"])

    rows1, wall1, direct1, _, _ = wave()
    rows2, wall2, direct2, before, after = wave()     # the steady state
    log(f"[phase 12] two waves of {ENGINE_REQUESTS} requests (1–"
        f"{ENGINE_MAX_ROWS} rows, both modes, both models): every answer "
        f"bit-identical to model.predict/transform; engine "
        f"{rows1 / wall1:.0f}, {rows2 / wall2:.0f} rows/s, per-request "
        f"model calls {rows1 / direct1:.0f}, {rows2 / direct2:.0f} rows/s")
    log(f"[phase 12] second wave, submit to drain: captures {before[0]} → "
        f"{after[0]}, staging buffers {before[1]} → {after[1]}, device "
        f"allocations {before[2]} → {after[2]}")
    if after != before or after[0] != expect:
        fail(f"the steady-state wave captured, staged or allocated: "
             f"{before} → {after} ({expect} cells after warmup)")

    lat = {}
    for name in names:
        for bucket in ENGINE_BUCKETS:
            xs = x_np[:bucket]
            times = []
            for _ in range(ENGINE_LATENCY_REPS):
                t0 = time.perf_counter()
                eng.predict(name, xs)
                times.append(time.perf_counter() - t0)
            p50, p99 = np.percentile(np.asarray(times) * 1e3, [50, 99])
            lat[(name, bucket)] = (float(p50), float(p99))
    log("[phase 12] predict latency p50/p99 ms by bucket: " + "; ".join(
        f"{m} {b}: {p50:.3f}/{p99:.3f}" for (m, b), (p50, p99) in
        lat.items()))

    replay = {}
    for name in names:
        slot = eng._resident[name].slot
        cell = eng._cells[(slot.id, ENGINE_BUCKETS[0], "predict")]

        def per_call(fn, reps=200):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return float(np.median(times) * 1e6)

        g_us = per_call(cell.graph.replay)
        e_us = per_call(lambda: cell.fn(cell.x))
        replay[name] = (g_us, e_us, sum(cell.launches.values()))
        log(f"[phase 12] {name} {ENGINE_BUCKETS[0]}-row predict cell "
            f"({sum(cell.launches.values())} wrapper launches "
            f"{cell.launches}): graph replay {g_us:.1f} µs, the same "
            f"launches issued eagerly {e_us:.1f} µs a call (host clock to a "
            "synchronize, medians of 200)")

    eng._run = run
    breakdown = {}
    for bucket in ENGINE_BUCKETS:
        cell = eng._cells[(rb_slot, bucket, "predict")]
        breakdown[bucket] = replay_breakdown(cell.graph)
        log(f"[phase 12] {names[0]} {bucket}-row predict replay: "
            f"{breakdown[bucket]}; {rb_replays[bucket]} replays of its "
            f"cells (each one degrees and one projection gather)")

    replayed = eng.stats()["replayed_launches"]
    log(f"[phase 12] kernel launches through the wrappers (eager warm-ups "
        f"and captures): {counts}; by graph replays: {replayed}")
    missing = [k for k in ENGINE_KERNELS
               if counts[k] <= 0 or replayed.get(k, 0) <= 0]
    if missing:
        fail(f"the engine's RB path did not launch {missing}")

    lru = ClusterEngine(EngineConfig(buckets=ENGINE_BUCKETS,
                                     max_resident_models=1))
    for name, mdl in models.items():
        lru.load_model(name, mdl)
        lru.warmup(name)
    compiles = lru.total_compiles
    for rep in range(3):
        for name, mdl in models.items():
            xs = x_np[rep * 1_000:rep * 1_000 + 3_000]
            if not np.array_equal(lru.predict(name, xs), mdl.predict(xs)):
                fail(f"the LRU leg's predict of {name} is not bit-identical")
    st = lru.stats()
    log(f"[phase 12] LRU leg (max_resident_models=1): bit-identical, "
        f"evictions {st['evictions']}, captures {compiles} → "
        f"{lru.total_compiles}, slots {st['slots']}")
    if lru.total_compiles != compiles or st["evictions"] < 5:
        fail("the LRU leg captured again or did not evict")
    del lru

    name = names[0]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.npz")
        models[name].save(path)
        with ClusterServer(eng) as srv:
            def post(route, body):
                req = urllib.request.Request(
                    srv.url + route, _json.dumps(body).encode(),
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    return _json.loads(r.read())

            post("/v1/models", {"name": "http", "path": path})
            labels = post("/v1/predict", {"model": "http",
                                          "rows": x_np[:300].tolist()})
    if not np.array_equal(labels["labels"], models[name].predict(
            x_np[:300])):
        fail("the HTTP round trip's labels differ from model.predict's")
    log(f"[phase 12] HTTP round trip through ClusterServer on {srv.url}: "
        f"300 labels equal to model.predict's")
    return {"replayed": replayed, "latency": lat, "replay": replay,
            "breakdown": breakdown, "rb_replays": rb_replays,
            "rows_s": (rows1 / wall1, rows2 / wall2),
            "direct_rows_s": (rows1 / direct1, rows2 / direct2)}


def replay_breakdown(graph, reps: int = 20) -> dict:
    """One RB predict cell's graph replay: host µs to a synchronize (median
    of 200), device µs (``time_device``), and the device µs of each of its
    kernels from a ``torch.profiler`` trace of ``reps`` replays (medians;
    its two gathers told apart by their order after the replay's
    rb_binning: the degrees' comes first). The kernels' times are None
    when the trace holds no device event."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    host = []
    for _ in range(200):
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    device_ms, _ = time_device(graph.replay, iters=20)
    for _ in range(2):        # the first trace of a process may hold none
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                graph.replay()
            torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end - e.time_range.start,
                     e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    kinds = {"rb_binning": [], "gather K 1": [], "gather K 7": [],
             "kmeans_assign": []}
    gathers = None                 # gathers since the replay's rb_binning
    for _, dur, name in events:
        if "rb_binning_kernel" in name:
            kinds["rb_binning"].append(dur)
            gathers = 0
        elif "gather" in name and gathers is not None and gathers < 2:
            kinds[("gather K 1", "gather K 7")[gathers]].append(dur)
            gathers += 1
        elif "kmeans_assign" in name:
            kinds["kmeans_assign"].append(dur)
    out = {"replay host us": round(float(np.median(host)) * 1e6, 1),
           "replay device us": round(device_ms * 1e3, 2)}
    for kind, durs in kinds.items():
        out[f"{kind} us"] = round(float(np.median(durs)), 2) if durs else None
    return out


def subspace_cosine(a, b) -> float:
    """Smallest principal-angle cosine between the column spans of two
    (N, K) host arrays."""
    import numpy as np
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return float(np.linalg.svd(qa.T @ qb, compute_uv=False).min())


def engine_gather_row(idx, v, s, d_g: int, big_d: int) -> dict:
    """``z_matmul``'s gather kernel at the serving engine's largest shape
    (phase 12): the top bucket's rows of the fit's pattern and row scales
    against a K-wide V, the predict cell's projection. Its other launch in
    a cell, the degrees' gather, is one column wide. The kernel and
    ``embedding_bag`` are timed on the device alone (a launch of
    microseconds), the plain version by events around its calls."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    n, k = ENGINE_BUCKETS[-1], COVTYPE[1]
    r = idx.shape[1]
    ie, se = idx[:n], s[:n].contiguous()
    ve = v[:, :k].contiguous()
    got = ops.z_matmul_gather(ie, ve, se, d_g=d_g)
    ok, err = within_sum_tolerance(got, ref.z_matmul_ref(ie, ve, se),
                                   ref.z_matmul_ref(ie, ve.abs(), se.abs()))
    if not ok:
        fail(f"z_matmul_gather differs from its plain version at {(n, r, k)}"
             f" (max abs {err:.3g})")
    w_bag = se[:, None].expand(n, r).contiguous()
    lib_ms, _ = time_device(lambda: torch.nn.functional.embedding_bag(
        ie, ve, mode="sum", per_sample_weights=w_bag))
    b_ms, b_by = gather_bound(ie, k)
    whole_v, _ = bound(*ops.z_matmul_cost(n, r, big_d, k))
    g_ms, _ = time_device(lambda: ops.z_matmul_gather(ie, ve, se, d_g=d_g))
    plain_ms = time_ms(lambda: ref.z_matmul_ref(ie, ve, se))
    log(f"[phase 2] z_matmul_gather at the engine's top bucket {(n, r)} x "
        f"K {k}: {g_ms:.4f} ms device, bound {b_ms:.4f} ms ({b_by}; "
        f"{whole_v:.4f} ms counting all of V), plain {plain_ms:.4f} ms, "
        f"embedding_bag {lib_ms:.4f} ms, max abs {err:.3g}")
    return dict(name="z_matmul_gather", route="cuda",
                source="src/repro_torch/kernels/csrc/ell_spmm.cu",
                replaces="src/repro/kernels/ell_spmm.py:85",
                max_abs_err=err, ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                check="|err| <= 1e-6 + 1e-5 * sum|terms|")


def gather_bound(ie, k: int) -> tuple[float, str]:
    """The gather's bound on this batch: idx, the V rows it references
    (each read once), s and y; one multiply-add a (row, grid, column)."""
    import torch
    n, r = ie.shape
    rows = torch.unique(ie).numel()
    return bound(n * r * 4 + rows * k * 4 + n * 4 + n * k * 4,
                 n * r * k + n * k)


def engine_gather_buckets(idx, v, s, d_g: int) -> dict:
    """The gather kernel at each of the engine's buckets for K = 1 (the
    degrees' launch, V the counts) and K = 7 (the projection), on the first
    rows of the fit's pattern: the bits of the in-order fold over the
    grids (acc += v[idx[:, g]] for g = 0 ... R-1, then · s, by elementwise
    adds on the card), device ms beside its bound and ``embedding_bag``'s;
    and a launch's floor (one row, one grid). Returns {(bucket, K): row}."""
    import torch

    from repro_torch.kernels import ops
    out = {}
    for n in ENGINE_BUCKETS:
        ie, se = idx[:n], s[:n].contiguous()
        for k in (1, COVTYPE[1]):
            ve = v[:, :k].contiguous()
            got = ops.z_matmul_gather(ie, ve, se, d_g=d_g)
            acc = torch.zeros_like(got)
            for col in ie.T.long():
                acc += ve[col]
            if not torch.equal(got, acc * se[:, None]):
                fail(f"z_matmul_gather at {n} rows, K {k} is not the "
                     "in-order fold over the grids")
            w_bag = se[:, None].expand_as(ie).contiguous()
            lib_ms, _ = time_device(lambda: torch.nn.functional.embedding_bag(
                ie, ve, mode="sum", per_sample_weights=w_bag), iters=100)
            ms, _ = time_device(
                lambda: ops.z_matmul_gather(ie, ve, se, d_g=d_g), iters=100)
            b_ms, b_by = gather_bound(ie, k)
            out[(n, k)] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                               library_ms=lib_ms)
            log(f"[phase 2] z_matmul_gather bucket {n} x K {k}: "
                f"{ms * 1e3:.2f} µs device, bound {b_ms * 1e3:.3f} µs "
                f"({b_by}), embedding_bag {lib_ms * 1e3:.2f} µs; the bits "
                f"of the in-order fold")
    i1, v1, s1 = idx[:1, :1].contiguous(), v[:d_g, :1].contiguous(), s[:1]
    floor, _ = time_device(lambda: ops.z_matmul_gather(i1, v1, s1, d_g=d_g),
                           iters=100)
    log(f"[phase 2] z_matmul_gather launch floor (1 row, 1 grid): "
        f"{floor * 1e3:.2f} µs device")
    return out


def cpu_drawn_plusplus():
    """A context in which k-means++ draws its seeds on the CPU (from a CPU
    generator with the device generator's seed, over a host copy of the
    rows) and hands them back on the rows' device: a fit on the card and
    one on the CPU then start Lloyd from the same rows."""
    import contextlib
    import importlib

    import torch

    # the package re-exports a ``kmeans`` function over the module's name
    km = importlib.import_module("repro_torch.core.kmeans")

    @contextlib.contextmanager
    def ctx():
        orig, gens = km._plusplus_init, {}

        def seeded(generator, x, k):
            _, g = gens.setdefault(id(generator), (generator, torch.Generator(
            ).manual_seed(generator.initial_seed())))
            return orig(g, x.cpu(), k).to(x.device)

        km._plusplus_init = seeded
        try:
            yield
        finally:
            km._plusplus_init = orig

    return ctx()


def phase13_partitioned(x_np, y_np, cfg, device_fit) -> dict:
    """The divide-and-conquer fit (placement="partitioned") at covtype's N:
    one worker, then a worker a partition on streams of their own; the
    card's launches, predict, save/load, the engine, the card against the
    CPU, and a host-chunked partitioned fit."""
    import numpy as np
    import torch

    from repro_torch.core import (
        PartitionOptions, SCRBModel, executor, metrics, partitioned,
    )
    from repro_torch.kernels import ops
    from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig

    def pcfg(n_parts, workers, **fields):
        return dataclasses.replace(cfg, **fields, partition=PartitionOptions(
            n_partitions=n_parts, workers=workers))

    fits = {}
    for w in PART_WORKERS:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = SCRBModel.fit(x_np, pcfg(PART_N, w))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        res = model.fit_result
        d = res.diagnostics["partitioned"]
        fits[w] = (model, counts)
        log(f"[phase 13] partitioned fit, {PART_N} partitions of "
            f"{d['partition_rows']} rows, workers={d['workers']}: "
            f"{wall:.3f}s; stages (s): " + ", ".join(
                f"{k}={v:.3f}" for k, v in res.timer.times.items())
            + f"; sub-fits (s) "
            f"{[round(t, 3) for t in d['partition_fit_s']]}; LOBPCG "
            f"iterations ≤ {res.diagnostics['solver_iterations']}; merged "
            f"singular values {[float(f'{v:.5f}') for v in res.singular_values]}")
        log(f"[phase 13] launches (workers={w}): {counts}")
        missing = [k for k in PART_KERNELS if counts[k] <= 0]
        if missing:
            fail(f"the partitioned fit (workers={w}) launched no {missing}")
    (m1, c1), (m4, c4) = fits[1], fits[4]
    r1, r4 = m1.fit_result, m4.fit_result
    same = bool(np.array_equal(r1.labels, r4.labels)
                and np.array_equal(r1.singular_values, r4.singular_values))
    log(f"[phase 13] workers 1 and {PART_WORKERS[1]}: labels and merged "
        f"singular values bit-identical = {same}; launch counts equal = "
        f"{c1 == c4}")
    if not same:
        fail("the partitioned fit's labels or merged singular values differ "
             "between one worker and a stream a partition")
    if c1 != c4:
        fail(f"launch counts differ between the workers: {c1} and {c4}")

    # predict on the training rows: the labelling pass's launches
    ops.reset_launch_counts()
    pred = m1.predict(x_np)
    label_counts = ops.launch_counts()
    agree = float(np.mean(pred == r1.labels))
    log(f"[phase 13] predict on the training rows agrees with the fit "
        f"labels at {agree:.6f}")
    if agree != 1.0:
        fail(f"predict on the training rows gives the fit labels at "
             f"{agree:.6f}, not 1")
    # the launches, counted from the sub-fits run one by one
    parts = partitioned.partition_rows(x_np, PART_N, shuffle=True,
                                       seed=cfg.seed)
    sub_cfg = dataclasses.replace(cfg, partition=None)
    sub_plan = executor.ExecutionPlan(feature_map=m1.feature_map)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    for part in parts:
        ops.reset_launch_counts()
        partitioned._fit_partition(part, sub_cfg, sub_plan,
                                   torch.device("cuda"))
        for k, v in ops.launch_counts().items():
            want[k] += v
    want["zt_matmul"] += PART_N     # the merge: one-hot rmatvec a partition
    for k, v in label_counts.items():
        want[k] += v                # the labelling pass
    log(f"[phase 13] sub-fits one by one + a zt a partition + the "
        f"labelling pass: {want}")
    if c4 != want:
        fail(f"the {PART_WORKERS[1]}-worker fit counted {c4} launches, the "
             f"sub-fits, merge and labelling {want}")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "partitioned.npz")
        m1.save(path)
        loaded = SCRBModel.load(path)
        same = bool(np.array_equal(loaded.predict(x_np), pred))
        log(f"[phase 13] save -> load -> predict bit-identical = {same}")
        if not same:
            fail("the loaded partitioned model predicts other labels")
    eng = ClusterEngine(EngineConfig(buckets=(PART_ENGINE_BUCKET,)))
    eng.load_model("partitioned", m1)
    rows = x_np[:PART_ENGINE_BUCKET]
    same = bool(np.array_equal(eng.predict("partitioned", rows),
                               m1.predict(rows)))
    log(f"[phase 13] engine at bucket {PART_ENGINE_BUCKET}: labels equal "
        f"to model.predict = {same}")
    if not same:
        fail("the engine serves the partitioned model other labels")
    del eng

    busy = device_busy(lambda: SCRBModel.fit(x_np, pcfg(PART_N,
                                                         PART_WORKERS[1])))
    log(f"[phase 13] {PART_WORKERS[1]}-worker fit: device busy "
        f"{busy['busy_us'] / 1e3:.1f} ms of {busy['wall_us'] / 1e3:.1f} ms "
        f"wall (idle share {1 - busy['busy_us'] / busy['wall_us']:.3f}, "
        f"{busy['device_events']} device events)")

    ari3 = metrics.adjusted_rand_index(r1.labels, device_fit["labels"])
    log(f"[phase 13] against phase 3's single fit: ARI {ari3:.4f}; "
        f"accuracy against the planted labels {metrics.accuracy(r1.labels, y_np):.4f}"
        f" (phase 3: {metrics.accuracy(device_fit['labels'], y_np):.4f}); "
        "not gated: the merge approximates the global solve")

    # the card against the CPU, the same draws
    xs = x_np[:PART_CPU_ROWS]
    with cpu_drawn_plusplus():
        t0 = time.perf_counter()
        card = executor.execute(xs, pcfg(PART_N, 1), device="cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = executor.execute(xs, pcfg(PART_N, 1), device="cpu")
        t_cpu = time.perf_counter() - t0
    ari = metrics.adjusted_rand_index(card.labels, cpu.labels)
    sig_rel = float(np.max(np.abs(card.singular_values - cpu.singular_values)
                           / cpu.singular_values))
    log(f"[phase 13] {PART_CPU_ROWS} rows, card {t_card:.2f}s against the "
        f"CPU {t_cpu:.2f}s (k-means++ drawn on the CPU for both): ARI "
        f"{ari:.4f}, merged singular values within {sig_rel:.3g} relative")
    if ari < PART_ARI:
        fail(f"the partitioned fit on the card agrees with the CPU's at ARI "
             f"{ari:.4f} < {PART_ARI}")

    # host-chunked partitions on a prefix
    xc = x_np[:PART_CHUNKED_ROWS]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunked = SCRBModel.fit(xc, pcfg(PART_CHUNKED_N, 1,
                                     chunk_size=PART_CHUNK))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = chunked.fit_result
    log(f"[phase 13] host-chunked partitioned fit, {PART_CHUNKED_N} "
        f"partitions of the first {PART_CHUNKED_ROWS} rows in chunks of "
        f"{PART_CHUNK}: {wall:.2f}s ({res.diagnostics['n_chunks']} chunks); "
        "stages (s): " + ", ".join(f"{k}={v:.3f}"
                                   for k, v in res.timer.times.items())
        + f"; launches {counts}")
    missing = [k for k in PART_CHUNKED_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"the host-chunked partitioned fit launched no {missing}")
    if res.diagnostics["plan"]["residency"] != "host_chunked":
        fail("the chunked partitioned fit did not run host-chunked")
    agree = float(np.mean(chunked.predict(xc) == res.labels))
    log(f"[phase 13] its predict on the training rows agrees at {agree:.6f}")
    if agree != 1.0:
        fail(f"the host-chunked partitioned model predicts its fit labels "
             f"at {agree:.6f}")
    if not (np.all(np.isfinite(r1.singular_values))
            and r1.labels.shape == (x_np.shape[0],)):
        fail("malformed partitioned fit")
    return {"launches": c1, "model": m1}


def single_summary(res, wall: float) -> dict:
    """What a mesh fit is held to of a single fit on the card."""
    d = res.diagnostics
    return {"sig": res.singular_values, "labels": res.labels,
            "embedding": res.embedding, "iterations": d["solver_iterations"],
            "solver": d["solver"], "wall": wall,
            "svd_s": res.timer.times["svd"]}


def single_solver_fits(x_np, cfg, have: dict) -> tuple:
    """The single fits on the card that the mesh's solver fits are held to:
    those of ``have`` (phase 9's), the rest fitted here. The compressive
    fit gets LOBPCG's bracket (θ_K, θ_K+1) from a fit at K + 1
    (CompressiveOptions.lambdas: the cold eigencount misplaces the cutoff
    on such data, ROADMAP.md C5). Returns (fits, {solver: config dict})."""
    import numpy as np

    k = cfg.n_clusters
    wide, _ = timed_execute(x_np, with_solver(cfg, "lobpcg",
                                              n_clusters=k + 1))
    theta = np.asarray(wide.singular_values, np.float64) ** 2
    bracket = [float(theta[k - 1]), float(theta[k])]
    del wide
    cfgs = {s: with_solver(cfg, s, **({"compressive_lambdas": bracket}
                                      if s == "compressive" else {}))
            for s in MESH_SOLVERS}
    fits = dict(have)
    for s in MESH_SOLVERS:
        if s not in fits:
            res, wall = timed_execute(x_np, cfgs[s])
            fits[s] = single_summary(res, wall)
            del res
    log(f"[solvers] single fits on the card for the mesh: LOBPCG's bracket "
        f"(theta_K, theta_K+1) = ({bracket[0]:.6f}, {bracket[1]:.6f}) for "
        f"the compressive cell; " + "; ".join(
            f"{s} {f['wall']:.3f}s, {f['iterations']} iterations"
            for s, f in fits.items()))
    return fits, {s: c.to_dict() for s, c in cfgs.items()}


def one_process_subset_labels(emb, cfg_dict: dict):
    """The compressive cell's k-means (a subset, then every row assigned)
    over a whole embedding in this process, on card 0: what a mesh fit's
    compressive labels are held to."""
    from types import SimpleNamespace

    import torch

    from repro_torch.core import SCRBConfig, compressive
    from repro_torch.utils import fold_seed
    cfg = SCRBConfig.from_dict(cfg_dict)
    u = torch.as_tensor(emb, device="cuda")
    rows = SimpleNamespace(kind="device", n=u.shape[0], device=u.device,
                           map_row_chunks=lambda fn, *t: fn(*t))
    km, _ = compressive.subset_cluster(rows, u, fold_seed(cfg.seed, "kmeans"),
                                       cfg)
    return km.labels.numpy()


def time_all_reduce(group, rows: int) -> dict:
    """ms of one all_reduce of a (rows, EIG_BLOCK) payload, float32 and
    bfloat16, over ``group`` (host clock, device synchronised)."""
    import torch
    import torch.distributed as dist
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.ones((rows, EIG_BLOCK), dtype=dtype, device="cuda")
        for _ in range(3):
            dist.all_reduce(q, group=group)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_REDUCE_REPS):
            dist.all_reduce(q, group=group)
        torch.cuda.synchronize()
        out[str(dtype)[6:]] = (time.perf_counter() - t0) * 1e3 \
            / MESH_REDUCE_REPS
    return out


def time_all_gather(group, rows: int) -> dict:
    """ms of one all_gather of this rank's (rows, w) float32 block into
    the global one (``distributed.all_gather_rows``: a global mat-vec's
    collective), at each width of MESH_GATHER_WIDTHS."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import all_gather_rows
    out = {}
    for w in MESH_GATHER_WIDTHS:
        t = torch.ones((rows, w), dtype=torch.float32, device="cuda")
        for _ in range(3):
            all_gather_rows(t, group)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_REDUCE_REPS):
            all_gather_rows(t, group)
        torch.cuda.synchronize()
        out[w] = (time.perf_counter() - t0) * 1e3 / MESH_REDUCE_REPS
    return out


def mesh_solver_fits(x, solver_cfgs: dict, mesh, save) -> dict:
    """A mesh fit of each solver on this rank (``save(name, embedding)``
    keeps rank 0's gathered embedding), with the all_gather ms of a global
    mat-vec at each width."""
    from repro_torch.core import SCRBConfig
    from repro_torch.launch import mesh as lm
    out = {}
    for name, cd in solver_cfgs.items():
        model, wall, counts = mesh_fit(x, SCRBConfig.from_dict(cd), mesh,
                                       None, False)
        out[name] = fit_summary(model, wall, counts)
        save(name, model.fit_result.embedding)
        del model
    gather_ms = time_all_gather(lm.data_group(mesh),
                                x.shape[0] // lm.data_shards(mesh))
    for f in out.values():
        f["all_gather_ms"] = gather_ms
    return out


def hold_mesh_solver(tag: str, fits: list, single: dict, emb,
                     one_process_labels) -> None:
    """A mesh fit of one solver (each rank's summary) against the same
    solver's single fit on the card."""
    import numpy as np

    from repro_torch.core import metrics
    f = fits[0]
    theta = np.asarray(f["sig"], np.float64) ** 2
    theta1 = np.asarray(single["sig"], np.float64) ** 2
    rel = float(np.max(np.abs(theta - theta1) / np.maximum(
        np.abs(theta1), np.finfo(np.float32).tiny)))
    k = theta.shape[0]
    sine = float(max(0.0, 1.0 - min(subspace_cosine(
        emb[:, :k], single["embedding"][:, :k]), 1.0) ** 2) ** 0.5)
    ari1 = metrics.adjusted_rand_index(f["labels"], one_process_labels)
    ari_single = metrics.adjusted_rand_index(f["labels"], single["labels"])
    iters = [g["iterations"] for g in fits]
    widths = f["all_gather_ms"]
    gather = ("none (the cell's mat-vecs stay on the shards)"
              if f["solver"] == "compressive" else
              f"{widths[1 if f['solver'] == 'lanczos' else EIG_BLOCK]:.3f} ms")
    log(f"[mesh] {tag}: fit {f['wall']:.2f}s (single {single['wall']:.2f}s),"
        f" svd {f['stages']['svd']:.3f}s (single {single['svd_s']:.3f}s); "
        f"{f['solver']}, iterations {iters} on the ranks (single "
        f"{single['iterations']}); Gram products {f['counts']['zt_matmul']} "
        f"zt and {f['counts']['z_matmul']} z launches; all_gather a global "
        f"mat-vec {gather}; Ritz values "
        f"{[float(f'{t:.6f}') for t in theta]}, within {rel:.3g} relative "
        f"of the single fit's; embedding sine {sine:.3g}; labels ARI "
        f"{ari1:.4f} against the same k-means in one process, {ari_single:.4f} against "
        f"the single fit's; launches {f['counts']}")
    if len(set(iters)) != 1:
        fail(f"{tag}: the ranks took {iters} iterations")
    if not all(np.array_equal(g["labels"], f["labels"]) for g in fits):
        fail(f"{tag}: the ranks' labels differ")
    if f["solver"] != single["solver"]:
        fail(f"{tag} ran {f['solver']}, the single fit {single['solver']}")
    if not np.all(np.isfinite(theta)) or rel > RITZ_RTOL:
        fail(f"{tag}: Ritz values {rel:.3g} off the single fit's (limit "
             f"{RITZ_RTOL:g} relative)")
    if ari1 < MESH_ARI:
        fail(f"{tag}: labels agree with the same k-means in one process at "
             f"ARI {ari1:.4f} < {MESH_ARI}")
    if f["labels"].shape != single["labels"].shape:
        fail(f"{tag}: labels of shape {f['labels'].shape}")


MESH_FITS = (("fp32", None, False), ("fp32 again", None, False),
             ("bf16", None, True), ("chunked", MESH_CHUNK, False))
MESH_U_SEED = 14


def require_built() -> None:
    """A spawned rank loads the libraries phase 1 built, never builds."""
    from repro_torch.kernels import _build
    missing = [n for n in _build.LIBRARIES
               if not _build.library_path(n).exists()]
    if missing:
        raise RuntimeError(f"kernels {missing} are not built")


def mesh_fit(x, cfg, mesh, chunk, compress):
    """One mesh fit on this rank: (model, host seconds, launches)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import SCRBModel, executor
    from repro_torch.kernels import ops

    c = dataclasses.replace(cfg, chunk_size=chunk)
    if compress:
        c = dataclasses.replace(c, solver_iters=MESH_BF16_ITERS)
    plan = dataclasses.replace(executor.plan_from_config(c, mesh=mesh),
                               collective_compress=compress)
    dist.barrier()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = SCRBModel.fit(x, c, plan=plan)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, ops.launch_counts()


def fit_summary(model, wall: float, counts: dict) -> dict:
    res = model.fit_result
    d = res.diagnostics
    return {"labels": res.labels, "sig": res.singular_values,
            "iterations": d["solver_iterations"], "solver": d["solver"],
            "resmax": float(max(d["solver_resnorms"])), "wall": wall,
            "stages": dict(res.timer.times), "counts": counts,
            "plan": d["plan"],
            "kmeans_chunk_rows": d.get("kmeans_chunk_rows"),
            "shard_rows": d["shard_rows"]}


def mesh_rank(tmp: str, cfg_dict: dict, solver_cfgs: dict) -> dict:
    """Phase 14 on one rank of the gloo world on the one card: the mesh fits
    (fp32 twice, bf16 payload, chunks within the shard), predict with the
    mesh, this shard's ELL pattern, counts and one Gram product, the
    all_reduce of the (D, K) payload, and a fit of each other solver."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import SCRBConfig
    from repro_torch.core.distributed import make_degree_pass, make_gram_matvec
    from repro_torch.launch import mesh as lm
    from repro_torch.utils import make_generator

    require_built()
    x = np.load(Path(tmp) / "x.npy")
    cfg = SCRBConfig.from_dict(cfg_dict)
    mesh = lm.make_host_mesh()
    rank = lm.data_rank(mesh)
    out = {"rank": rank, "backend": dist.get_backend(), "fits": {}}
    for i, (tag, chunk, compress) in enumerate(MESH_FITS):
        model, wall, counts = mesh_fit(x, cfg, mesh, chunk, compress)
        out["fits"][tag] = fit_summary(model, wall, counts)
        if rank == 0:
            np.save(Path(tmp) / f"emb{i}.npy", model.fit_result.embedding)
        if i == 0:
            first = model
    rows = x[:MESH_PREDICT_ROWS]
    out["predict_equal"] = bool(np.array_equal(
        first.predict(rows, mesh=mesh), first.predict(rows)))

    n = x.shape[0]
    lo, m = lm.data_rank(mesh) * n // lm.data_shards(mesh), \
        n // lm.data_shards(mesh)
    fm = first.feature_map
    idx = fm.transform(torch.as_tensor(x[lo:lo + m], device="cuda"))
    out["idx_sha"] = hashlib.sha256(idx.cpu().numpy().tobytes()).hexdigest()
    deg, counts = make_degree_pass(mesh, idx, fm.n_features, fm.d_g)()
    out["counts"] = counts.cpu().numpy()
    scale = 1.0 / torch.sqrt(float(fm.n_grids) * torch.clamp_min(deg, 1e-8))
    u = torch.randn((n, EIG_BLOCK), generator=make_generator(MESH_U_SEED))
    gram = make_gram_matvec(mesh, idx, scale, fm.n_features, fm.d_g)
    out["gram"] = gram(u[lo:lo + m].to("cuda")).cpu().numpy()

    del first, idx, deg, scale, gram
    out["all_reduce_ms"] = time_all_reduce(lm.data_group(mesh),
                                           fm.n_features)

    def save(name, emb):
        if rank == 0:
            np.save(Path(tmp) / f"emb_{name}.npy", emb)

    out["solver_fits"] = mesh_solver_fits(
        x, {s: solver_cfgs[s] for s in MESH_SOLVERS_GLOO}, mesh, save)
    return out


def nccl_rank(tmp: str, cfg_dict: dict, n_embeddings: int) -> dict:
    """Phase 14 in an NCCL world of 1: the mesh fit, and the mesh's k-means
    run in one process over each embedding the other fits saved."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import SCRBConfig
    from repro_torch.core.distributed import distributed_kmeans
    from repro_torch.launch import mesh as lm
    from repro_torch.utils import fold_seed

    require_built()
    x = np.load(Path(tmp) / "x.npy")
    cfg = SCRBConfig.from_dict(cfg_dict)
    mesh = lm.make_host_mesh()
    model, wall, counts = mesh_fit(x, cfg, mesh, None, False)
    out = {"backend": dist.get_backend(), "fit": fit_summary(model, wall,
                                                             counts),
           "embedding": model.fit_result.embedding, "kmeans": []}
    names = ["emb3.npy"] + [f"emb{i}.npy" for i in range(n_embeddings)] \
        + [f"emb_{s}.npy" for s in MESH_SOLVERS_GLOO if s != "compressive"]
    for name in names:
        u = torch.as_tensor(np.load(Path(tmp) / name), device="cuda")
        res, _ = distributed_kmeans(
            fold_seed(cfg.seed, "kmeans"), u, cfg.n_clusters, mesh,
            n=u.shape[0], n_iters=cfg.kmeans_iters,
            n_replicates=cfg.kmeans_replicates)
        out["kmeans"].append(res.labels.numpy())
    return out


def phase14_mesh(x_np, cfg, device_fit, fm3, solver_fits) -> dict:
    """The mesh placement at covtype's N: a gloo world of 2 ranks sharing
    the one card (290,506 rows a shard), then an NCCL world of 1; held
    against phase 3's single fit and the single card's kernels, and each
    other solver's mesh fit against its single fit (phase 9's)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import graph, metrics
    from repro_torch.kernels import ops
    from repro_torch.launch.world import run_world
    from repro_torch.utils import make_generator

    n = x_np.shape[0]
    rows = n // MESH_WORLD
    theta3 = np.asarray(device_fit["singular_values"], np.float64) ** 2
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "x.npy", x_np)
        np.save(Path(tmp) / "emb3.npy", device_fit["embedding"])
        # the single card: the fit's ELL pattern, its exact counts, and the
        # fused Gram product with the row scales of those counts' degrees
        idx = fm3.transform(torch.as_tensor(x_np, device="cuda"))
        digests = [hashlib.sha256(idx[i * rows:(i + 1) * rows].cpu().numpy()
                                  .tobytes()).hexdigest()
                   for i in range(MESH_WORLD)]
        counts = ops.bin_counts(idx, d=fm3.n_features, d_g=fm3.d_g)
        deg = graph.degrees_from_counts(idx, counts)
        scale = 1.0 / torch.sqrt(float(fm3.n_grids)
                                 * torch.clamp_min(deg, 1e-8))
        u = torch.randn((n, EIG_BLOCK), generator=make_generator(MESH_U_SEED))
        want = ops.gram_matmul(idx, u.to("cuda"), scale, fm3.n_features,
                               d_g=fm3.d_g).cpu().numpy()
        counts = counts.cpu().numpy()
        del idx, deg, scale, u
        torch.cuda.empty_cache()

        singles, solver_cfgs = single_solver_fits(x_np, cfg, solver_fits)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_world(mesh_rank, MESH_WORLD, backend="gloo",
                          device="cuda:0",
                          args=(tmp, cfg.to_dict(), solver_cfgs),
                          timeout_s=60.0, join_timeout_s=MESH_JOIN_S)
        t_gloo = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl, = run_world(nccl_rank, 1, backend="nccl", device="cuda",
                          args=(tmp, cfg.to_dict(), len(MESH_FITS)),
                          timeout_s=60.0, join_timeout_s=MESH_JOIN_S)
        t_nccl = time.perf_counter() - t0
        embs = [np.load(Path(tmp) / f"emb{i}.npy")
                for i in range(len(MESH_FITS))]
        solver_embs = {s: np.load(Path(tmp) / f"emb_{s}.npy")
                       for s in MESH_SOLVERS_GLOO}
    log(f"[phase 14] gloo world of {MESH_WORLD} on one card: {t_gloo:.1f}s "
        f"(spawn included); NCCL world of 1: {t_nccl:.1f}s")
    r0 = ranks[0]
    if [r["rank"] for r in ranks] != list(range(MESH_WORLD)) or \
            r0["backend"] != "gloo" or nccl["backend"] != "nccl":
        fail("the worlds are not the ones asked for")

    same_ell = all(r["idx_sha"] == digests[r["rank"]] for r in ranks)
    same_counts = all(np.array_equal(r["counts"], counts) for r in ranks)
    got = np.concatenate([r["gram"] for r in ranks])
    gram_rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[phase 14] each shard's ELL indices equal to the single fit's rows "
        f"= {same_ell}; the (D,) counts after all_reduce equal to the "
        f"single card's bin_counts = {same_counts}; one Gram product "
        f"(local zt, all_reduce, local z) within {gram_rel:.3g} relative of "
        "the fused single-card product")
    if not (same_ell and same_counts):
        fail("the mesh's ELL pattern or counts differ from the single fit's")
    if gram_rel > MESH_GRAM_RTOL:
        fail(f"the mesh's Gram product is {gram_rel:.3g} off the fused "
             f"product (limit {MESH_GRAM_RTOL:g} relative)")

    def hold(tag, fit, emb, one_process_labels, bf16=False):
        theta = np.asarray(fit["sig"], np.float64) ** 2
        ritz = float(np.max(np.abs(theta - theta3)))
        k = theta.shape[0]
        sine = float(max(0.0, 1.0 - min(subspace_cosine(
            emb[:, :k], device_fit["embedding"][:, :k]), 1.0) ** 2) ** 0.5)
        ari3 = metrics.adjusted_rand_index(fit["labels"],
                                           device_fit["labels"])
        ari1 = metrics.adjusted_rand_index(fit["labels"], one_process_labels)
        log(f"[phase 14] {tag}: fit {fit['wall']:.2f}s, stages (s) "
            + ", ".join(f"{s}={v:.3f}" for s, v in fit["stages"].items())
            + f"; {fit['iterations']} iterations (phase 3: "
            f"{device_fit['iterations']}), resnorm max {fit['resmax']:.3g}; "
            f"Ritz values within {ritz:.3g} of phase 3's; sine of the "
            f"embedding's largest principal angle to phase 3's {sine:.3g}; "
            f"labels ARI {ari1:.4f} against the same k-means in one "
            f"process, {ari3:.4f} against phase 3's; kmeans_chunk_rows "
            f"{fit['kmeans_chunk_rows']}, shard rows {fit['shard_rows']}")
        limit = MESH_BF16_RITZ_ATOL if bf16 else MESH_RITZ_ATOL
        if ritz > limit:
            fail(f"{tag}: Ritz values {ritz:.3g} off phase 3's (limit "
                 f"{limit:g})")
        if sine > MESH_SINE and not bf16:
            fail(f"{tag}: the embedding is {sine:.3g} off phase 3's span")
        if ari1 < MESH_ARI:
            fail(f"{tag}: labels agree with the same k-means in one process "
                 f"at ARI {ari1:.4f} < {MESH_ARI}")
        if fit["labels"].shape != (n,):
            fail(f"{tag}: labels of shape {fit['labels'].shape}")
        return ari3

    for i, (tag, chunk, compress) in enumerate(MESH_FITS):
        fits = [r["fits"][tag] for r in ranks]
        if not all(np.array_equal(f["labels"], fits[0]["labels"])
                   for f in fits):
            fail(f"{tag}: the ranks' labels differ")
        hold(f"gloo x{MESH_WORLD} {tag}", fits[0], embs[i],
             nccl["kmeans"][1 + i], bf16=compress)
        if fits[0]["kmeans_chunk_rows"] != (chunk or rows):
            fail(f"{tag}: k-means swept {fits[0]['kmeans_chunk_rows']} rows "
                 f"at a time, not {chunk or rows}")
    again = np.array_equal(r0["fits"]["fp32"]["labels"],
                           r0["fits"]["fp32 again"]["labels"])
    log(f"[phase 14] a repeat fit gives the same labels = {again}; "
        f"predict(mesh=) on {MESH_PREDICT_ROWS} rows equal to a one-process "
        f"predict = {all(r['predict_equal'] for r in ranks)}")
    if not again:
        fail("two mesh fits gave different labels")
    if not all(r["predict_equal"] for r in ranks):
        fail("predict(mesh=) differs from predict()")
    ari_pool3 = metrics.adjusted_rand_index(nccl["kmeans"][0],
                                            device_fit["labels"])
    log(f"[phase 14] the mesh's k-means (a pool of 64 rows seeds k-means++) "
        f"over phase 3's own embedding agrees with phase 3's labels at ARI "
        f"{ari_pool3:.4f}: the covtype-shaped data has no cluster gap, so "
        "k-means settles by its seeds")
    hold("nccl x1", nccl["fit"], nccl["embedding"], nccl["fit"]["labels"])
    ari_worlds = metrics.adjusted_rand_index(nccl["fit"]["labels"],
                                             r0["fits"]["fp32"]["labels"])
    log(f"[phase 14] nccl x1 against gloo x{MESH_WORLD} fp32: ARI "
        f"{ari_worlds:.4f}")
    if ari_worlds < MESH_ARI:
        fail(f"the NCCL world's labels agree with the gloo world's at ARI "
             f"{ari_worlds:.4f} < {MESH_ARI}")

    # every other solver on the mesh, against its single fit
    kmeans_at = 1 + len(MESH_FITS)
    for name in MESH_SOLVERS_GLOO:
        if name == "compressive":
            one = one_process_subset_labels(solver_embs[name],
                                            solver_cfgs[name])
        else:
            one = nccl["kmeans"][kmeans_at]
            kmeans_at += 1
        hold_mesh_solver(f"gloo x{MESH_WORLD} {name}",
                         [r["solver_fits"][name] for r in ranks],
                         singles[name], solver_embs[name], one)
    del solver_embs

    counts0 = r0["fits"]["fp32"]["counts"]
    log(f"[phase 14] launches a mesh fit (rank 0 of {MESH_WORLD}): "
        f"{counts0}")
    missing = [k for k in MESH_KERNELS if counts0[k] <= 0]
    if missing:
        fail(f"the mesh fit launched no {missing}")
    if counts0["gram_matmul"]:
        fail("a mesh Gram product took the fused kernel, which cannot sum "
             "q over the ranks")
    it = r0["fits"]["fp32"]["iterations"]
    log(f"[phase 14] all_reduce of the (D, K) = ({counts.shape[0]}, "
        f"{EIG_BLOCK}) payload, two ranks sharing one card over gloo: "
        f"{r0['all_reduce_ms']['float32']:.2f} ms float32 "
        f"({counts.shape[0] * EIG_BLOCK * 4 / 1e6:.1f} MB), "
        f"{r0['all_reduce_ms']['bfloat16']:.2f} ms bf16 "
        f"({counts.shape[0] * EIG_BLOCK * 2 / 1e6:.1f} MB); ~{it + it // 16 + 2}"
        " Gram products a fit. Not a scaling figure: both ranks share the "
        "card and the host")
    return {"launches": counts0}


# --------------------------------------------------------------------------
# phase 15: more than one card (--cards N)
# --------------------------------------------------------------------------

def library_outputs(dev, x_np, fm) -> dict:
    """Each library's entry points on card ``dev`` at small shapes, held
    against the plain version on the same card: {kernel: (outputs on the
    host, max abs error against the plain version)}. The strip route of
    z_matmul (227 KB of shared memory), the statistics form of
    kmeans_assign at d 16, K 64 (57 KB) and the bf16 flash kernel (hd 128)
    each need their shared-memory limit lifted on this card."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref

    def host(*ts):
        return tuple(t.cpu() for t in ts)

    out = {}
    gen = torch.Generator().manual_seed(15)
    with torch.cuda.device(dev):
        x = torch.as_tensor(x_np, device=dev)
        f = fm.to(dev)
        p = f.params
        idx = ops.rb_binning(x, p.widths, p.biases, p.hash_a, p.hash_c,
                             d_g=p.d_g)
        want = ref.rb_binning_ref(x, p.widths, p.biases, p.hash_a,
                                  p.hash_c, p.d_g)
        if not torch.equal(idx, want):
            fail(f"rb_binning on {dev} differs from its plain version")
        out["rb_binning"] = (host(idx), 0.0)

        d, d_g = f.n_features, p.d_g
        counts = ops.bin_counts(idx, d=d, d_g=d_g)
        if not torch.equal(counts, ref.bin_counts_ref(idx, d)):
            fail(f"bin_counts on {dev} differs from its plain version")
        out["bin_counts"] = (host(counts), 0.0)

        v = torch.randn((d, EIG_BLOCK), generator=gen).to(dev)
        u = torch.randn((idx.shape[0], EIG_BLOCK), generator=gen).to(dev)
        s = torch.rand((idx.shape[0],), generator=gen).to(dev) + 0.5
        y = ops.z_matmul(idx, v, s, d_g=d_g)
        yg = ops.z_matmul_gather(idx, v, s, d_g=d_g)
        q = ops.zt_matmul(idx, u, s, d=d, d_g=d_g)
        g = ops.gram_matmul(idx, u, s, d, d_g=d_g)
        if not torch.equal(y, yg):
            fail(f"z_matmul's strip kernel on {dev} differs from its gather "
                 "kernel")
        if not torch.equal(g, ops.z_matmul(idx, q, s, d_g=d_g)):
            fail(f"the fused Gram product on {dev} differs from zt then z")
        yw = ref.z_matmul_ref(idx, v, s)
        qw = ref.zt_matmul_ref(idx, u, s, d)
        for name, got, want, terms in (
                ("z_matmul", y, yw, ref.z_matmul_ref(idx, v.abs(), s)),
                ("zt_matmul", q, qw, ref.zt_matmul_ref(idx, u.abs(), s, d))):
            if not within_sum_tolerance(got, want, terms)[0]:
                fail(f"{name} on {dev} is off its plain version")
        err = max(float((y - yw).abs().max()), float((q - qw).abs().max()))
        out["ell_spmm"] = (host(y, yg, q, g), err)

        rng = np.random.default_rng(15)
        for dd, k, n in ((7, 7, 131_072), (16, 64, 20_000)):
            xs = torch.as_tensor(rng.integers(-8, 8, size=(n, dd))
                                 .astype(np.float32), device=dev)
            cs = torch.as_tensor(rng.integers(-8, 8, size=(k, dd))
                                 .astype(np.float32), device=dev)
            lab, dist2 = ops.kmeans_assign(xs, cs)
            wl, wd = ref.kmeans_assign_ref(xs, cs)
            st = ops.kmeans_assign_stats(xs, cs)
            onehot = torch.nn.functional.one_hot(st[0].long(), k).float()
            if not (torch.equal(lab, wl) and torch.equal(dist2, wd)
                    and torch.equal(st[0], lab)
                    and torch.equal(st[1], onehot.sum(0))
                    and torch.equal(st[2], onehot.T @ xs)):
                fail(f"kmeans_assign (d {dd}, K {k}) on {dev} differs from "
                     "its plain version")
            out[f"kmeans_assign d{dd} K{k}"] = (host(lab, dist2, *st), 0.0)

        for hd, dtype in ((128, torch.bfloat16), (64, torch.float32)):
            qa = torch.randn((1, 1000, 4, hd), generator=gen).to(dev, dtype)
            ka = torch.randn((1, 1000, 2, hd), generator=gen).to(dev, dtype)
            va = torch.randn((1, 1000, 2, hd), generator=gen).to(dev, dtype)
            got = ops.flash_attention(qa, ka, va, causal=True)
            want = ref.flash_attention_bshd_ref(qa, ka, va, causal=True)
            err = float((got.float() - want.float()).abs().max())
            tol = FLASH_TOL[str(dtype)[6:]]
            if err > tol:
                fail(f"flash_attention ({dtype}) on {dev} is {err:.3g} off "
                     f"its plain version (limit {tol:g})")
            out[f"flash_attention {str(dtype)[6:]}"] = (host(got), err)
        torch.cuda.synchronize(dev)
    return out


def phase15a_cards(n_cards: int, x_np, fm) -> None:
    """Every library on card 0, then on each other card, in this process."""
    import torch

    from repro_torch.kernels import ops
    base = None
    for c in range(n_cards):
        dev = torch.device("cuda", c)
        ops.reset_launch_counts()
        got = library_outputs(dev, x_np, fm)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        same = None
        if base is None:
            base = got
        else:
            same = all(all(torch.equal(a, b) for a, b in
                           zip(got[name][0], base[name][0])) for name in got)
        log(f"[phase 15] {dev}: every library against its plain version ok "
            f"(max abs errors " + ", ".join(
                f"{k} {v[1]:.3g}" for k, v in got.items())
            + f"); launches {counts}"
            + ("" if same is None else
               f"; every output bit-equal to cuda:0's = {same}"))
        if same is False:
            fail(f"the kernels on {dev} give other bits than on cuda:0")


def nccl_cards_rank(tmp: str, cfg_dict: dict, solver_cfgs: dict,
                    full: bool, kmeans_names: list) -> dict:
    """Phase 15 on one rank of an NCCL world, one rank a card: the fp32 mesh
    fit, this shard's counts and degrees, the all_reduce of the (D, K)
    payload; with ``full`` also chunks within the shards, the bf16 payload,
    each other solver, predict and transform with the mesh; and the mesh's
    k-means over each embedding in ``kmeans_names`` (in a world of 1)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import SCRBConfig
    from repro_torch.core.distributed import (
        all_gather_rows, distributed_kmeans, make_degree_pass,
    )
    from repro_torch.launch import mesh as lm
    from repro_torch.utils import fold_seed

    require_built()
    x = np.load(Path(tmp) / "x.npy")
    cfg = SCRBConfig.from_dict(cfg_dict)
    mesh = lm.make_host_mesh()
    rank, world = lm.data_rank(mesh), dist.get_world_size()
    group = lm.data_group(mesh)
    out = {"rank": rank, "backend": dist.get_backend(),
           "card": torch.cuda.current_device(), "fits": {}}

    def save(name, emb):
        if rank == 0:
            np.save(Path(tmp) / f"emb_{world}_{name}.npy", emb)

    fits = [("fp32", None, False)]
    if full:
        fits += [("chunked", MESH_CHUNK, False), ("bf16", None, True)]
    for tag, chunk, compress in fits:
        model, wall, counts = mesh_fit(x, cfg, mesh, chunk, compress)
        out["fits"][tag] = fit_summary(model, wall, counts)
        save(tag, model.fit_result.embedding)
        if tag == "fp32":
            first = model
        else:
            del model
    n = x.shape[0]
    rows = n // lm.data_shards(mesh)
    lo = rank * rows
    fm = first.feature_map
    idx = fm.transform(torch.as_tensor(x[lo:lo + rows], device="cuda"))
    deg, counts = make_degree_pass(mesh, idx, fm.n_features, fm.d_g)()
    out["counts"] = counts.cpu().numpy()
    out["deg"] = all_gather_rows(deg, group).cpu().numpy()
    del idx, deg
    out["all_reduce_ms"] = time_all_reduce(group, fm.n_features)
    if full:
        prow = x[:MESH_PREDICT_ROWS]
        pred = first.predict(prow, mesh=mesh)
        out["predict_equal"] = bool(np.array_equal(pred, first.predict(prow)))
        out["predict_agree"] = float(np.mean(
            pred == first.fit_result.labels[:MESH_PREDICT_ROWS]))
        out["transform_equal"] = bool(np.array_equal(
            first.transform(prow[:4096], mesh=mesh),
            first.transform(prow[:4096])))
        del first
        out["solver_fits"] = mesh_solver_fits(x, solver_cfgs, mesh, save)
    out["kmeans"] = {}
    if world == 1:           # its own fit's embedding too
        kmeans_names = kmeans_names + [f"emb_{world}_fp32.npy"]
    for name in kmeans_names:
        u = torch.as_tensor(np.load(Path(tmp) / name), device="cuda")
        res, _ = distributed_kmeans(
            fold_seed(cfg.seed, "kmeans"), u, cfg.n_clusters, mesh,
            n=u.shape[0], n_iters=cfg.kmeans_iters,
            n_replicates=cfg.kmeans_replicates)
        out["kmeans"][name] = res.labels.numpy()
    return out


def phase15b_nccl(n_cards: int, x_np, cfg, single: dict, singles: dict,
                  solver_cfgs: dict) -> dict:
    """The mesh over NCCL, one rank a card, at 1, 2 and ``n_cards`` ranks,
    against the single fit on cuda:0 (``single``: its Ritz values, counts,
    degrees and labels)."""
    import numpy as np

    from repro_torch.launch.world import run_world

    n = x_np.shape[0]
    d = single["counts"].shape[0]
    worlds = sorted({2, n_cards}) + [1]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "x.npy", x_np)
        for w in worlds:
            full = w == n_cards
            names = []
            if w == 1:        # the same k-means in one process, each fit's
                names = sorted(p.name for p in Path(tmp).glob("emb_*.npy")
                               if not p.name.endswith("_compressive.npy"))
            t0 = time.perf_counter()
            ranks = run_world(nccl_cards_rank, w, backend="nccl",
                              device="cuda",
                              args=(tmp, cfg.to_dict(), solver_cfgs, full,
                                    names),
                              timeout_s=60.0, join_timeout_s=CARDS_JOIN_S)
            log(f"[phase 15] NCCL world of {w}, one rank a card (cards "
                f"{[r['card'] for r in ranks]}): {time.perf_counter() - t0:.1f}"
                "s, spawn included")
            if [r["rank"] for r in ranks] != list(range(w)) or \
                    {r["backend"] for r in ranks} != {"nccl"} or \
                    [r["card"] for r in ranks] != list(range(w)):
                fail(f"the NCCL world of {w} is not one rank a card")
            results[w] = ranks
        embs = {p.name: np.load(p) for p in Path(tmp).glob("emb_*.npy")}
    one = results[1][0]["kmeans"]
    theta1 = np.asarray(single["sig"], np.float64) ** 2
    out = {}
    for w in worlds:
        ranks = results[w]
        r0 = ranks[0]
        for tag, f in r0["fits"].items():
            fits = [r["fits"][tag] for r in ranks]
            iters = [g["iterations"] for g in fits]
            theta = np.asarray(f["sig"], np.float64) ** 2
            ritz = float(np.max(np.abs(theta - theta1)))
            name = f"emb_{w}_{tag}.npy"
            ari1 = adjusted_rand_index(f["labels"], one[name])
            ari_single = adjusted_rand_index(f["labels"], single["labels"])
            log(f"[phase 15] nccl x{w} {tag}: fit {f['wall']:.3f}s; stages "
                "(s) " + ", ".join(f"{s}={v:.3f}"
                                   for s, v in f["stages"].items())
                + f"; iterations {iters} on the ranks (single "
                f"{single['iterations']}), resnorm max {f['resmax']:.3g}; "
                f"Ritz values within {ritz:.3g} of the single fit's; labels "
                f"ARI {ari1:.4f} against the same k-means in one process, "
                f"{ari_single:.4f} against the single fit's; launches "
                f"{f['counts']}")
            limit = MESH_BF16_RITZ_ATOL if tag == "bf16" \
                else MESH_NCCL_RITZ_ATOL
            if len(set(iters)) != 1:
                fail(f"nccl x{w} {tag}: the ranks took {iters} iterations")
            if not all(np.array_equal(g["labels"], f["labels"])
                       for g in fits):
                fail(f"nccl x{w} {tag}: the ranks' labels differ")
            if not np.all(np.isfinite(theta)) or ritz > limit:
                fail(f"nccl x{w} {tag}: Ritz values {ritz:.3g} off the "
                     f"single fit's (limit {limit:g})")
            if ari1 < MESH_ARI:
                fail(f"nccl x{w} {tag}: labels agree with the same k-means "
                     f"in one process at ARI {ari1:.4f} < {MESH_ARI}")
            if f["labels"].shape != (n,):
                fail(f"nccl x{w} {tag}: labels of shape {f['labels'].shape}")
        same_counts = all(np.array_equal(r["counts"], single["counts"])
                          for r in ranks)
        same_deg = all(np.array_equal(r["deg"], single["deg"])
                       for r in ranks)
        ar = r0["all_reduce_ms"]
        mb = d * EIG_BLOCK * 4 / 1e6
        ring = 2 * (w - 1) / w * d * EIG_BLOCK * 4 / NVLINK_BYTES_PER_S * 1e3
        log(f"[phase 15] nccl x{w}: counts bit-equal to the single card's = "
            f"{same_counts}, degrees bit-equal = {same_deg}; all_reduce of "
            f"the ({d}, {EIG_BLOCK}) payload {ar['float32']:.4f} ms float32 "
            f"({mb:.1f} MB; a ring all-reduce's bound over NVLink at "
            f"{NVLINK_BYTES_PER_S / 1e9:.0f} GB/s each way {ring:.4f} ms), "
            f"{ar['bfloat16']:.4f} ms bf16")
        if not (same_counts and same_deg):
            fail(f"nccl x{w}: counts or degrees differ from the single "
                 "card's")
        out[w] = {"fits": r0["fits"], "all_reduce_ms": ar, "ring_ms": ring}
        if w != n_cards:
            continue
        if not all(r["predict_equal"] and r["transform_equal"]
                   for r in ranks):
            fail(f"nccl x{w}: predict(mesh=) or transform(mesh=) differs "
                 "from the one-process call")
        agree = min(r["predict_agree"] for r in ranks)
        log(f"[phase 15] nccl x{w}: predict(mesh=) on {MESH_PREDICT_ROWS} "
            f"rows agrees with the fit's labels at {agree:.6f}, equal to "
            "predict() and transform(mesh=) to transform() = True")
        if agree < 0.99:
            fail(f"nccl x{w}: predict(mesh=) agrees with the fit at "
                 f"{agree:.6f} < 0.99")
        for name in MESH_SOLVERS:
            emb = embs[f"emb_{w}_{name}.npy"]
            labels = one_process_subset_labels(emb, solver_cfgs[name]) \
                if name == "compressive" else one[f"emb_{w}_{name}.npy"]
            hold_mesh_solver(f"nccl x{w} {name}",
                             [r["solver_fits"][name] for r in ranks],
                             singles[name], emb, labels)
    return out


def adjusted_rand_index(a, b) -> float:
    from repro_torch.core import metrics
    return metrics.adjusted_rand_index(a, b)


def busy_by_card(fn, n_cards: int) -> dict:
    """Each card's busy share over ``fn()`` (phase 9's method, the trace's
    device events split by card): {card: (busy ms, wall ms)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for c in range(n_cards):
            torch.cuda.synchronize(c)

    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    out = {}
    for c in range(n_cards):
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.device_index == c)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        out[c] = (busy / 1e3, wall)
    return out


def phase15c_partitioned(n_cards: int, x_np, cfg) -> None:
    """The partitioned fit with partition i on card i mod ``n_cards``
    (device="cuda"), at one worker and a worker a card, against the same
    fit on cuda:0 alone."""
    import numpy as np
    import torch

    from repro_torch.core import PartitionOptions, SCRBModel
    from repro_torch.serve.cluster_engine import ClusterEngine, EngineConfig

    def pcfg(workers):
        return dataclasses.replace(cfg, partition=PartitionOptions(
            n_partitions=PART_N, workers=workers))

    fits = {}
    for device, workers in (("cuda:0", 1), ("cuda", 1),
                            ("cuda", n_cards)):
        for c in range(n_cards):
            torch.cuda.synchronize(c)
        t0 = time.perf_counter()
        model = SCRBModel.fit(x_np, pcfg(workers), device=device)
        for c in range(n_cards):
            torch.cuda.synchronize(c)
        wall = time.perf_counter() - t0
        res = model.fit_result
        d = res.diagnostics["partitioned"]
        fits[(device, workers)] = model
        log(f"[phase 15] partitioned fit, device={device!r}, {d['devices']} "
            f"card(s), {PART_N} partitions, workers={d['workers']}: "
            f"{wall:.3f}s; stages (s) " + ", ".join(
                f"{k}={v:.3f}" for k, v in res.timer.times.items())
            + f"; sub-fits (s) {[round(t, 3) for t in d['partition_fit_s']]}")
    base = fits[("cuda:0", 1)].fit_result
    for key, model in fits.items():
        res = model.fit_result
        same = bool(np.array_equal(res.labels, base.labels)
                    and np.array_equal(res.singular_values,
                                       base.singular_values))
        if not same:
            fail(f"the partitioned fit {key} differs from the fit on cuda:0 "
                 "alone")
    log(f"[phase 15] partitioned labels and merged singular values "
        f"bit-identical on cuda:0 alone, on {n_cards} cards at one worker "
        f"and at {n_cards} = True")
    m = fits[("cuda", n_cards)]
    pred = m.predict(x_np)
    agree = float(np.mean(pred == m.fit_result.labels))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "partitioned.npz")
        m.save(path)
        loaded = bool(np.array_equal(SCRBModel.load(path).predict(x_np),
                                     pred))
    eng = ClusterEngine(EngineConfig(buckets=(PART_ENGINE_BUCKET,)))
    eng.load_model("partitioned", m)
    rows = x_np[:PART_ENGINE_BUCKET]
    served = bool(np.array_equal(eng.predict("partitioned", rows),
                                 m.predict(rows)))
    del eng
    log(f"[phase 15] the {n_cards}-card model: predict on the training rows "
        f"agrees at {agree:.6f}; save -> load -> predict bit-identical = "
        f"{loaded}; engine equal to model.predict = {served}")
    if agree != 1.0 or not loaded or not served:
        fail("the multi-card partitioned model does not serve its fit")
    for workers in (1, n_cards):
        busy = busy_by_card(lambda: SCRBModel.fit(x_np, pcfg(workers),
                                                  device="cuda"), n_cards)
        log(f"[phase 15] partitioned fit on {n_cards} cards, workers="
            f"{workers}: idle share by card " + ", ".join(
                f"cuda:{c} {1 - b / w:.3f} ({b:.1f} ms busy of {w:.1f})"
                for c, (b, w) in busy.items()))


def phase15_cards(n_cards: int) -> None:
    """More than one card: the kernels on every card, the mesh over NCCL at
    1, 2 and ``n_cards`` ranks, the partitioned fit across the cards, and
    what the cards and their links are."""
    import torch

    from repro_torch.core import RBMap, SCRBConfig, SCRBModel, graph
    from repro_torch.core.rb import suggest_sigma
    from repro_torch.data.synthetic import SuiteSpec, generate
    from repro_torch.kernels import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for line in smi:
        log(f"[phase 15] card {line}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    for line in topo.rstrip().splitlines():
        log(f"[phase 15] topo | {line}")

    x_np, _ = generate(SuiteSpec(*COVTYPE), scale=1.0, seed=0)
    sigma = suggest_sigma(x_np)
    cfg = SCRBConfig(n_clusters=COVTYPE[1], n_grids=N_GRIDS, sigma=sigma)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    fm = RBMap(n_grids=N_GRIDS, sigma=sigma).fit(cfg.seed, x_np)
    phase15a_cards(n_cards, x_np[:Z_STRIP_ROWS_15], fm)
    log(f"[phase 15] (a) {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = SCRBModel.fit(x_np, cfg, device="cuda:0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    res = model.fit_result
    f = model.feature_map
    idx = f.transform(torch.as_tensor(x_np, device="cuda:0"))
    counts = ops.bin_counts(idx, d=f.n_features, d_g=f.d_g)
    deg = graph.degrees_from_counts(idx, counts)
    single = {"sig": res.singular_values, "labels": res.labels,
              "iterations": res.diagnostics["solver_iterations"],
              "counts": counts.cpu().numpy(), "deg": deg.cpu().numpy()}
    del idx, deg, counts, model, res
    log(f"[phase 15] single fit on cuda:0: {wall:.3f}s, "
        f"{single['iterations']} iterations")
    singles, solver_cfgs = single_solver_fits(x_np, cfg, {})
    for c in range(n_cards):
        with torch.cuda.device(c):
            torch.cuda.empty_cache()
    phase15b_nccl(n_cards, x_np, cfg, single, singles, solver_cfgs)
    log(f"[phase 15] (b) {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    phase15c_partitioned(n_cards, x_np, cfg)
    log(f"[phase 15] (c) {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------------
# phase 16: the DeepSeek models (MLA, MoE)
# --------------------------------------------------------------------------

def plain_attention_f32(q, k, v, scale: float, window=None):
    """Causal float32 attention, (B, S, H, dq) x (B, T, H, dq) x (B, T, H,
    dv) -> (B, S, H, dv), a chunk of query rows at a time; with ``window``
    key j is visible from query i only if i - window < j <= i."""
    import torch
    b, s, h, _ = q.shape
    out = q.new_empty((b, s, h, v.shape[-1]))
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    for c0 in range(0, s, DS_TRUTH_CHUNK):
        hi = min(s, c0 + DS_TRUTH_CHUNK)
        sc = torch.matmul(qh[:, :, c0:hi], kh[:, :, :hi].transpose(-1, -2))
        kpos = torch.arange(hi, device=q.device)[None, :]
        qpos = torch.arange(c0, hi, device=q.device)[:, None]
        later = kpos > qpos
        if window is not None:
            later |= kpos <= qpos - window
        p = torch.softmax((sc * scale).masked_fill_(later, float("-inf")),
                          dim=-1)
        out[:, c0:hi] = torch.matmul(p, vh[:, :, :hi]).transpose(1, 2)
    return out


def swiglu_f32(x, wg, wu, wd):
    import torch.nn.functional as F
    return (F.silu(x @ wg.float()) * (x @ wu.float())) @ wd.float()


def mla_truth(cfg, mod, h, cos, sin):
    """The MLA mixer in float32 on the bf16 input ``h``, written out apart
    from the port: each head's keys and values decompressed from the latent
    (no absorption), the rotary key shared by the heads, plain causal
    attention."""
    import math

    import torch

    from repro_torch.models import layers as L
    m, heads = cfg.mla, cfg.n_heads
    dn, dr, dv, lo = m.qk_nope_dim, m.qk_rope_dim, m.v_dim, m.kv_lora_rank
    b, s, _ = h.shape
    w = {n: p.detach().float() for n, p in mod.named_parameters()}
    x = h.float()
    q = (x @ w["wq"]).view(b, s, heads, dn + dr)
    q = torch.cat([q[..., :dn], L.apply_rope(q[..., dn:], cos, sin)], -1)
    dkv = x @ w["w_dkv"]
    ckv = L.rmsnorm(dkv[..., :lo], w["kv_ln"], cfg.norm_eps)
    kr = L.apply_rope(dkv[..., lo:][:, :, None], cos, sin)
    k = torch.cat([(ckv @ w["w_uk"]).view(b, s, heads, dn),
                   kr.expand(b, s, heads, dr)], -1)
    v = (ckv @ w["w_uv"]).view(b, s, heads, dv)
    o = plain_attention_f32(q, k, v, 1.0 / math.sqrt(dn + dr))
    return o.reshape(b, s, heads * dv) @ w["wo"]


def moe_truth(cfg, mod, h):
    """The MoE FFN in float32 on the bf16 input ``h``, written out apart
    from the port, at the bf16 run's routing: its top-k experts (the
    router product in bf16, as served), gates from the float32
    probabilities there, renormalised, and its capacity drops (a slot's
    rank among its expert's slots in (token, choice) order). Returns the
    output, each token's agreement of its float32 top-k set with the bf16
    one, and both routings."""
    import math

    import torch
    import torch.nn.functional as F
    mo = cfg.moe
    e, k = mo.n_routed, mo.top_k
    b, s, d = h.shape
    x = h.float()
    idx = torch.softmax((h @ mod.router).float(), -1).topk(k, -1).indices
    probs = torch.softmax(x @ mod.router.float(), -1)
    idx32 = probs.topk(k, -1).indices
    agree = (idx.sort(-1).values == idx32.sort(-1).values).all(-1)
    g = probs.gather(-1, idx)
    g = g / g.sum(-1, keepdim=True)
    cap = max(math.ceil(s * k * mo.capacity_factor / e), 1)
    flat = idx.reshape(b, s * k, 1)
    rank = (F.one_hot(flat[..., 0], e).cumsum(1) - 1).gather(-1, flat)
    wgt = (g * (rank.view(b, s, k) < cap)).view(b * s, k)
    sh = mod.shared
    out = swiglu_f32(x, sh.wg, sh.wu, sh.wd).view(b * s, d)
    xf, idf = x.view(b * s, d), idx.view(b * s, k)
    ex = mod.experts
    for j in range(e):
        tok, slot = (idf == j).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu_f32(xf[tok], ex.wg[j], ex.wu[j], ex.wd[j])
            out.index_add_(0, tok, y * wgt[tok, slot, None])
    return out.view(b, s, d), agree, idx, idx32


class _CheckDone(Exception):
    """Ends a prefill early, once its hooks have what they need."""


def deepseek_layer_check(cfg, params, batch, stop_at=None) -> dict:
    """One bf16 prefill, each layer's mixer and FFN output held against
    its float32 truth on the same input (module hooks); on GQA layers the
    flash kernel's output against its plain version too. With
    ``stop_at`` (a layer kind) the prefill stops after the first layer of
    that kind is measured. Returns {kind: [row error max per layer]}, the
    MoE layers' disagreeing shares and their row errors on every token,
    and the flash rows."""
    from unittest import mock

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_bshd_ref as plain
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    out = {"mla": [], "gqa": [], "mlp": [], "moe": [], "moe_all": [],
           "disagree": [], "flash": []}

    def done(kind):
        if kind == stop_at:
            raise _CheckDone

    def mixer_hook(kind):
        def hook(mod, args, kwargs, res):
            h, cos, sin = args
            if kind == "mla":
                want = mla_truth(cfg, mod, h, cos, sin)
            else:
                # the port's GQA in float32, through the plain attention
                g32 = L.GQA(cfg, device=h.device, dtype=torch.float32)
                g32.load_state_dict(mod.state_dict())
                with mock.patch.object(ops, "flash_attention", plain):
                    want = g32(h.float(), cos, sin,
                               window=kwargs["window"])[0]
            out[kind].append(float(row_errors(res[0], want).max()))
            done(kind)
        return hook

    def ffn_hook(kind):
        def hook(mod, args, res):
            (h,) = args
            if kind == "moe":
                want, agree, _, _ = moe_truth(cfg, mod, h)
                err = row_errors(res[0], want)
                out["moe"].append(float(err[agree].max()))
                out["moe_all"].append(float(err.max()))
                out["disagree"].append(float(1.0 - agree.float().mean()))
            else:
                want = swiglu_f32(h.float(), mod.wg, mod.wu, mod.wd)
                out["mlp"].append(float(row_errors(res, want).max()))
            done(kind)
        return hook

    handles = []
    for seg, layers in zip(cfg.segments, params.segments):
        for layer in layers:
            handles.append(layer.mixer.register_forward_hook(
                mixer_hook(seg.mixer), with_kwargs=True))
            handles.append(layer.ffn.register_forward_hook(
                ffn_hook(seg.ffn)))
    try:
        with mock.patch.object(ops, "flash_attention", checked_attention(
                ops.flash_attention, out["flash"])):
            T.prefill(cfg, params, batch,
                      T.init_cache(cfg, LM_BATCH, LM_CACHE))
    except _CheckDone:
        pass
    finally:
        for hd in handles:
            hd.remove()
        torch.cuda.empty_cache()
    return out


def ds_planted_faults() -> dict:
    """(layer kind, a fault in the port's code: the function it replaces
    in ``repro_torch.models.layers`` and what a bug there returns)."""
    from repro_torch.models import layers as L

    def scores_without_rope(q_lat, q_rope, ckv, kr):
        b, h, c, lo = q_lat.shape
        return L.bmm_f32(q_lat.reshape(b, h * c, lo),
                         ckv.transpose(1, 2)).view(b, h, c, ckv.shape[1])

    def gates_not_renormalised(cfg, p, x):
        probs = (x @ p.router).float().softmax(-1)
        gates, eidx = probs.topk(cfg.moe.top_k, dim=-1)
        return probs, gates, eidx

    return {"MLA scores without the rope term":
            ("mla", "mla_scores", scores_without_rope),
            "MoE gates not renormalised":
            ("moe", "moe_route", gates_not_renormalised)}


def layer_times(cfg, params, batch) -> dict:
    """Device ms of the first layer of the model's last segment on its
    prefill inputs: its mixer (uncached, the prompt's attention or scan)
    and its FFN (where it has one), each timed alone with CUDA events."""
    from repro_torch.models import transformer as T

    layer = params.segments[-1][0]
    seen = {}

    def grab_mixer(mod, args, kwargs, res):
        seen["mixer"] = (args, kwargs["window"])
        if layer.ffn is None:
            raise _CheckDone

    def grab_ffn(mod, args, res):
        seen["ffn"] = args[0]
        raise _CheckDone

    hooks = [layer.mixer.register_forward_hook(grab_mixer, with_kwargs=True)]
    if layer.ffn is not None:
        hooks.append(layer.ffn.register_forward_hook(grab_ffn))
    try:
        T.forward_hidden(cfg, params, batch)
    except _CheckDone:
        pass
    finally:
        for hd in hooks:
            hd.remove()
    (h, cos, sin), window = seen["mixer"]
    times = {"mixer": time_ms(lambda: layer.mixer(h, cos, sin,
                                                  window=window), iters=5)}
    if layer.ffn is not None:
        times["ffn"] = time_ms(lambda: layer.ffn(seen["ffn"]), iters=5)
    return times


def deepseek_model(arch: str, seed: int) -> dict:
    """Phase 16 for one model; returns its kernel launches per generate."""
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tag = f"[phase 16] {arch}"
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != cfg.param_count():
        fail(f"{arch}: {n_params} parameters, the config counts "
             f"{cfg.param_count()}")
    kinds = [(seg.mixer, seg.ffn, seg.count) for seg in cfg.segments]
    log(f"{tag}: {cfg.n_layers} layers {kinds}, d={cfg.d_model}, "
        f"H={cfg.n_heads}, mla={cfg.mla}, moe={cfg.moe}, "
        f"vocab={cfg.vocab_size}, {cfg.dtype}: {n_params} parameters "
        f"({n_params * 2 / 2**30:.2f} GiB) drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}

    # the layer-by-layer float32 check, then the planted faults against it
    t0 = time.perf_counter()
    chk = deepseek_layer_check(cfg, params, batch)
    n_mixer = {"mla": 0, "gqa": 0}
    n_ffn = {"mlp": 0, "moe": 0}
    for mixer, ffn, count in kinds:
        n_mixer[mixer] += count
        n_ffn[ffn] += count
    for kind, n in {**n_mixer, **n_ffn}.items():
        rows = chk[kind]
        if len(rows) != n:
            fail(f"{arch}: the check measured {len(rows)} {kind} layers "
                 f"of {n}")
        if rows:
            log(f"{tag} {kind} layers vs float32 on the same input: row "
                f"error max {max(rows):.3g} (limit {DS_ROW_REL}), median "
                f"{sorted(rows)[len(rows) // 2]:.3g}, layer by layer "
                f"{[round(r, 5) for r in rows]}")
        if rows and max(rows) > DS_ROW_REL:
            fail(f"{arch}: {kind} layers differ from float32: {rows}")
    if chk["moe"]:
        dis = chk["disagree"]
        log(f"{tag} MoE routing: tokens whose top-{cfg.moe.top_k} set "
            f"differs between bf16 and float32: {min(dis):.5f}-"
            f"{max(dis):.5f} a layer (mean {sum(dis) / len(dis):.5f}); row "
            f"error max over every token, at the bf16 routing "
            f"{max(chk['moe_all']):.3g}")
    if n_mixer["gqa"]:
        fl = chk["flash"]
        log(f"{tag} flash kernel vs plain attention on each layer's "
            f"prefill inputs (H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
            f"hd={cfg.head_dim}): row error max {max(fl):.3g} over "
            f"{len(fl)} layers (limit {FLASH_ROW_REL})")
        if len(fl) != n_mixer["gqa"] or max(fl) > FLASH_ROW_REL:
            fail(f"{arch}: the flash kernel's attention in prefill differs "
                 f"from the plain version: {fl}")
    log(f"{tag} layer check {time.perf_counter() - t0:.1f}s")
    for name, (kind, fn, fault) in ds_planted_faults().items():
        if not n_mixer.get(kind, n_ffn.get(kind)):
            continue
        with mock.patch.object(L, fn, fault):
            got = deepseek_layer_check(cfg, params, batch, stop_at=kind)
        err = got[kind][0]
        log(f"{tag} planted fault, {name}: first {kind} layer's row error "
            f"{err:.3g} (limit {DS_ROW_REL}) -> fails the check")
        if err <= DS_ROW_REL:
            fail(f"{arch}: the float32 layer check passes a planted fault "
                 f"({name})")

    served = serve_requests(tag, cfg, params, prompts, seed,
                            flash_layers=n_mixer["gqa"])
    st, greedy = served["stats"], served["greedy"]
    n_moe = n_ffn["moe"]
    mo = cfg.moe
    expert_bytes = n_moe * 3 * mo.n_routed * cfg.d_model * mo.d_expert * 2
    step_ms = st["decode_s"] / st["decode_steps"] * 1e3
    last = cfg.segments[-1]
    lt = layer_times(cfg, params, batch)
    log(f"{tag} one {last.mixer}+{last.ffn} layer on the prefill's inputs "
        f"(device, CUDA events): mixer {lt['mixer']:.3f} ms, FFN "
        f"{lt['ffn']:.3f} ms; x {last.count} layers "
        f"{(lt['mixer'] + lt['ffn']) * last.count / 1e3:.4f} s of the "
        f"prefill's {st['prefill_s']:.4f} s")
    # one decode step's device busy time (torch.profiler; a spin cannot
    # time it: its thousands of launches fill the launch queue behind one)
    caches = T.init_cache(cfg, LM_BATCH, LM_CACHE)
    T.prefill(cfg, params, batch, caches)
    tok = torch.as_tensor(greedy[:, 0], device="cuda")
    for _ in range(2):         # the second trace: the first pays set-up
        busy = device_busy(
            lambda: T.decode_step(cfg, params, tok, caches, LM_PROMPT))
    del caches
    log(f"{tag} one decode step at position {LM_PROMPT}: "
        f"{busy['device_events']} device events, the device busy "
        f"{busy['busy_us'] / 1e3:.3f} ms of {busy['wall_us'] / 1e3:.3f} ms "
        f"wall (busy share {busy['busy_us'] / busy['wall_us']:.3f})")
    log(f"{tag} decode reads every routed expert's weights each step (the "
        f"dense (G, E, C, D) products at C = 1): {expert_bytes / 1e9:.2f} "
        f"GB over {n_moe} MoE layers, a bound of "
        f"{expert_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms/step at 3.35 TB/s; "
        f"all {n_params * 2 / 1e9:.2f} GB of weights "
        f"{n_params * 2 / PEAK_BYTES_PER_S * 1e3:.3f} ms; measured "
        f"{step_ms:.3f} ms/step")
    del params
    return served["launches"]


def phase16_deepseek(seed: int) -> dict:
    """Phase 16: both DeepSeek models, the card freed between them;
    returns each one's kernel launches per generate."""
    import torch

    from repro_torch.models import layers as L

    # the float32 score product of bf16 operands (aten::bmm.dtype)
    g = torch.Generator("cuda").manual_seed(seed)
    a = torch.randn((4, 256, 512), generator=g, device="cuda").bfloat16()
    b = torch.randn((4, 512, 300), generator=g, device="cuda").bfloat16()
    got = L.bmm_f32(a, b)
    want = torch.bmm(a.double(), b.double())
    err = float((got.double() - want).abs().max())
    log(f"[phase 16] bmm_f32 of bf16 operands: {got.dtype}, max abs error "
        f"against float64 {err:.3g} (|want| max "
        f"{float(want.abs().max()):.3g})")
    if got.dtype != torch.float32 or err > 1e-3:
        fail(f"bmm_f32 of bf16 operands is {err:.3g} off float64")
    out = {}
    for arch in DS_ARCHS:
        t0 = time.perf_counter()
        out[arch] = deepseek_model(arch, seed)
        torch.cuda.empty_cache()
        log(f"[phase 16] {arch} {time.perf_counter() - t0:.1f}s, device "
            f"memory in use after freeing it "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return out


# --------------------------------------------------------------------------
# phase 17: Mamba2, Hymba, Qwen2-VL, MusicGen (SSM, hybrid, M-RoPE, embeds)
# --------------------------------------------------------------------------

def mrope_positions(b: int, s: int):
    """(3, B, S) positions on the card, Qwen2-VL's layout of an image among
    text: MROPE_TEXT text positions (the three streams equal), a
    MROPE_GRID² patch grid at t = MROPE_TEXT with h and w its row and
    column, then text from MROPE_TEXT + MROPE_GRID on."""
    import torch
    g, t0 = MROPE_GRID, MROPE_TEXT
    text = torch.arange(t0)
    tail = t0 + g + torch.arange(s - t0 - g * g)
    grid = (torch.full((g * g,), t0),
            t0 + torch.arange(g).repeat_interleave(g),
            t0 + torch.arange(g).repeat(g))
    pos = torch.stack([torch.cat([text, st, tail]) for st in grid])
    return pos[:, None].expand(3, b, s).contiguous().to("cuda")


def rope_truth(cfg, positions):
    """cos, sin (B, S, rotary_dim/2) float32, written apart from the port:
    each frequency's angle in float64, from the position stream that its
    M-RoPE section names for (3, B, S) positions, else from (B, S)."""
    import torch
    half = cfg.rotary_dim // 2
    dev = positions.device
    inv = cfg.rope_theta ** (-torch.arange(half, device=dev,
                                           dtype=torch.float64) / half)
    if positions.dim() == 3:
        stream = torch.repeat_interleave(
            torch.arange(3, device=dev),
            torch.tensor(cfg.mrope_sections, device=dev))
        pos = positions.permute(1, 2, 0)[..., stream]
    else:
        pos = positions[..., None]
    ang = pos.double() * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rms_f32(x, scale, eps: float):
    import torch
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def gqa_truth(cfg, mod, h, cos, sin, window):
    """The GQA mixer in float32 on the bf16 input ``h``, written apart from
    the port: the projections (and biases), RoPE of ``rope_truth``'s
    tables, each kv head repeated for its query heads, plain causal
    attention in the segment's window."""
    import math

    from repro_torch.models import layers as L
    b, s, _ = h.shape
    heads, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {n: p.detach().float() for n, p in mod.named_parameters()}
    x = h.float()
    q, k, v = (x @ w[f"w{n}"] + (w[f"b{n}"] if cfg.qkv_bias else 0)
               for n in "qkv")
    q, k, v = (t.view(b, s, -1, hd) for t in (q, k, v))
    if cfg.qk_norm:
        q, k = rms_f32(q, w["q_norm"], cfg.norm_eps), \
            rms_f32(k, w["k_norm"], cfg.norm_eps)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    k, v = (t.repeat_interleave(heads // kvh, dim=2) for t in (k, v))
    o = plain_attention_f32(q, k, v, 1.0 / math.sqrt(hd), window)
    return o.reshape(b, s, heads * hd) @ w["wo"]


def ssm_truth(cfg, mod, h):
    """The Mamba2 mixer in float32 on the bf16 input ``h`` (B, n, D),
    written apart from the port: the in-projection, the causal conv by its
    K taps, then the recurrence one position at a time, state ←
    exp(dt·A)·state + B ⊗ (dt·x) and y = C·state + D·x, gated by silu(z),
    normed and out-projected. Returns the output and the final state."""
    import torch
    import torch.nn.functional as F
    sc, d = cfg.ssm, cfg.d_model
    di, nh, n, hp = sc.d_inner(d), sc.n_heads(d), sc.d_state, sc.head_dim
    gn = sc.n_groups * n
    w = {name: p.detach().float() for name, p in mod.named_parameters()}
    x = h.float()
    b, s, _ = x.shape
    proj = x @ w["w_in"]
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * gn], \
        proj[..., 2 * di + 2 * gn:]
    kk = sc.conv_kernel
    xpad = F.pad(xbc, (0, 0, kk - 1, 0))
    conv = w["conv_b"] + sum(xpad[:, i:i + s] * w["conv_w"][i]
                             for i in range(kk))
    conv = F.silu(conv)
    xs = conv[..., :di].reshape(b, s, nh, hp)
    bm, cm = conv[..., di:di + n], conv[..., di + gn:di + gn + n]
    dt = F.softplus(dt + w["dt_bias"])
    decay = torch.exp(dt * -torch.exp(w["a_log"]))
    xdt = xs * dt[..., None]
    state = x.new_zeros((b, nh, n, hp))
    y = torch.empty_like(xs)
    for t in range(s):
        state = decay[:, t, :, None, None] * state \
            + bm[:, t, None, :, None] * xdt[:, t, :, None, :]
        y[:, t] = torch.einsum("bn,bhnp->bhp", cm[:, t], state)
    y = (y + xs * w["d_skip"][:, None]).reshape(b, s, di) * F.silu(z)
    return rms_f32(y, w["out_ln"], cfg.norm_eps) @ w["w_out"], state


def lm_layer_check(cfg, params, batch, stop_after=None) -> dict:
    """One bf16 prefill with module hooks: each layer's mixer output (for
    Hymba each branch and the fused output) and FFN output held against
    its float32 truth on the same input, and each flash output against its
    plain version. Attention rows cover all S positions; SSM and fused
    rows the first SSM_CHECK (``ssm_full``: all S of the first SSM layer,
    and ``state``: its final state in the cache, each (batch, head)'s N x
    P block a row). With ``stop_after`` (a layer index) the prefill stops
    once that layer's mixer is measured. Returns {kind: [row error max
    per layer]}."""
    from unittest import mock

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    out = {"attn": [], "ssm": [], "ssm_full": [], "state": [], "hybrid": [],
           "mlp": [], "flash": []}
    b, s = LM_BATCH, LM_PROMPT
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(s, device="cuda")[None].expand(b, s)
    cos, sin = rope_truth(cfg, pos)
    eps = cfg.norm_eps
    pending = {}

    def attn_hook(window):
        def hook(mod, args, kwargs, res):
            want = gqa_truth(cfg, mod, args[0], cos, sin, window)
            out["attn"].append(float(row_errors(res[0], want).max()))
            pending["attn"] = want[:, :SSM_CHECK]
        return hook

    def ssm_hook(mod, args, kwargs, res):
        n = SSM_CHECK if out["ssm"] else s
        want, state = ssm_truth(cfg, mod, args[0][:, :n])
        err = row_errors(res[0][:, :n], want)
        if n == s:
            out["ssm_full"].append(float(err.max()))
            out["state"].append(float(row_errors(
                kwargs["cache"]["state"].flatten(2),
                state.flatten(2)).max()))
        out["ssm"].append(float(err[:, :SSM_CHECK].max()))
        pending["ssm"] = want[:, :SSM_CHECK]

    def mixer_hook(index, kind):
        def hook(mod, args, kwargs, res):
            if kind == "hybrid":
                want = 0.5 * (rms_f32(pending.pop("attn"), mod.attn_out_ln,
                                      eps)
                              + rms_f32(pending.pop("ssm"), mod.ssm_out_ln,
                                        eps))
                out["hybrid"].append(float(row_errors(
                    res[0][:, :SSM_CHECK], want).max()))
            if index == stop_after:
                raise _CheckDone
        return hook

    def ffn_hook(mod, args, res):
        want = swiglu_f32(args[0].float(), mod.wg, mod.wu, mod.wd)
        out["mlp"].append(float(row_errors(res, want).max()))

    handles = []

    def hook(mod, fn):
        handles.append(mod.register_forward_hook(fn, with_kwargs=True))

    index = 0
    for seg, layers in zip(cfg.segments, params.segments):
        for layer in layers:
            mixer = layer.mixer
            if seg.mixer == "gqa":
                hook(mixer, attn_hook(seg.window))
            elif seg.mixer == "ssm":
                hook(mixer, ssm_hook)
            else:
                hook(mixer.attn, attn_hook(seg.window))
                hook(mixer.ssm, ssm_hook)
            hook(mixer, mixer_hook(index, seg.mixer))
            if layer.ffn is not None:
                handles.append(layer.ffn.register_forward_hook(ffn_hook))
            index += 1
    try:
        with mock.patch.object(ops, "flash_attention", checked_attention(
                ops.flash_attention, out["flash"])):
            T.prefill(cfg, params, batch,
                      T.init_cache(cfg, LM_BATCH, LM_CACHE))
    except _CheckDone:
        pass
    finally:
        for hd in handles:
            hd.remove()
        torch.cuda.empty_cache()
    return out


def new_planted_faults() -> dict:
    """name -> (model, the layer its check stops after, (object, attribute,
    the fault that replaces it), the row kind that must fail)."""
    import torch

    from repro_torch.models import layers as L
    chunk, gqa_forward, rope = L.ssd_chunk, L.GQA.forward, L.rope_tables

    def state_not_carried(state, *rest):
        # every chunk starts from state 0: y_inter is dropped, and the
        # final state holds the last chunk alone
        return chunk(torch.zeros_like(state), *rest)

    def window_ignored(self, x, cos, sin, *, window=None, cache=None,
                       pos=None):
        return gqa_forward(self, x, cos, sin, window=None, cache=cache,
                           pos=pos)

    def h_w_swapped(positions, *args, **kwargs):
        if positions.dim() == 3:
            positions = positions[[0, 2, 1]]
        return rope(positions, *args, **kwargs)

    return {"SSD scan not carrying the state between chunks (y_inter "
            "dropped)":
            ("mamba2-370m", 0, (L, "ssd_chunk", state_not_carried),
             "state"),
            "a windowed hybrid layer ignoring its window":
            ("hymba-1.5b", 1, (L.GQA, "forward", window_ignored), "attn"),
            "M-RoPE h and w sections swapped":
            ("qwen2-vl-7b", 0, (L, "rope_tables", h_w_swapped), "attn")}


def flash_at_model_shape(tag: str, cfg) -> None:
    """The flash kernel at the model's prefill shape (its windowed layers'
    window, if any): ``flash_at_shape``, printed."""
    windows = {seg.window for seg in cfg.segments} - {None}
    flash_at_shape(tag, LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                   cfg.head_dim, max(windows) if windows else None)


def flash_at_shape(tag: str, b: int, s: int, h: int, hkv: int, hd: int,
                   window=None, gate: bool = False) -> dict:
    """The flash kernel on random bf16 (b, s, h/hkv, hd) causal inputs:
    its largest row error against its plain version (``gate``: within
    FLASH_ROW_REL, else fail), timed beside SDPA (a windowed one with an
    explicit boolean mask, K and V repeated to H heads: SDPA's masked
    route takes no grouped K/V), the plain version and its bound over the
    visible pairs. Returns the kernels-line fields."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_bshd_ref as plain
    g = torch.Generator(device="cuda").manual_seed(h * hd)
    q, k, v = (torch.randn((b, s, n, hd), generator=g,
                           device="cuda").bfloat16() for n in (h, hkv, hkv))
    out = ops.flash_attention(q, k, v, window=window)
    want = plain(q, k, v, window=window)
    err = row_error(out, want)
    max_abs = float((out.float() - want.float()).abs().max())
    del out, want
    ms = time_ms(lambda: ops.flash_attention(q, k, v, window=window),
                 iters=20)
    plain_ms = time_ms(lambda: plain(q, k, v, window=window), iters=2,
                       warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    else:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) \
            & (i[None, :] > i[:, None] - window)
        kt, vt = (x.repeat_interleave(h // hkv, dim=1) for x in (kt, vt))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=20)
    pairs = visible_pairs(s, s, True, window)
    ops_n = 4.0 * hd * pairs * b * h
    b_ms, b_by = bound(2 * (2 * b * s * h * hd + 2 * b * s * hkv * hd),
                       ops_n, PEAK_BF16_OPS_PER_S)
    log(f"{tag} flash_attention at B={b} S=T={s} H={h} Hkv={hkv} hd={hd} "
        f"bf16 causal window={window}: row error against the plain version "
        f"{err:.3g} (limit {FLASH_ROW_REL}{'' if gate else ', printed'}), "
        f"max abs {max_abs:.3g}; ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
        f"{pairs} visible pairs a head) SDPA ms={sdpa_ms:.4f} "
        f"plain_ms={plain_ms:.4f}; {ops_n / ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / ms:.1%} of the bound")
    if gate and not err <= FLASH_ROW_REL:
        fail(f"{tag} the flash kernel at B={b} S={s} H={h}/{hkv} hd={hd} "
             f"is {err:.3g} from its plain version (limit {FLASH_ROW_REL})")
    return {"max_abs_err": max_abs, "row_error": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sdpa_ms}


def new_model(arch: str, seed: int) -> dict:
    """Phase 17 for one model; returns its kernel launches per generate."""
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T

    tag = f"[phase 17] {arch}"
    cfg = configs.get_config(arch)
    embeds = cfg.input_mode == "embeds"
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    # param_count counts an embedding that an embeds model does not have
    gap = cfg.vocab_size * cfg.d_model if embeds else 0
    if n_params != cfg.param_count() - gap:
        fail(f"{arch}: {n_params} parameters, the config counts "
             f"{cfg.param_count()} (less {gap} for no embedding)")
    kinds = [(seg.mixer, seg.ffn, seg.count, seg.window)
             for seg in cfg.segments]
    log(f"{tag}: {cfg.n_layers} layers {kinds}, d={cfg.d_model}, "
        f"H={cfg.n_heads}/{cfg.n_kv_heads}, hd={cfg.head_dim}, "
        f"ssm={cfg.ssm}, M-RoPE {cfg.mrope_sections}, input "
        f"{cfg.input_mode}, vocab={cfg.vocab_size}, {cfg.dtype}: {n_params} "
        f"parameters ({n_params * 2 / 2**30:.2f} GiB; param_count "
        f"{cfg.param_count()} less the embedding it counts, {gap}) drawn "
        f"on the card in {time.perf_counter() - t0:.2f}s")
    if embeds:
        g = torch.Generator("cuda").manual_seed(seed)
        prompts = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model),
                              generator=g, device="cuda") * EMBED_STD
        batch = {"embeds": prompts}
    else:
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
        batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    check_batch = batch
    if cfg.mrope_sections is not None:
        check_batch = dict(batch, positions=mrope_positions(LM_BATCH,
                                                            LM_PROMPT))

    # the layer-by-layer float32 check, then the planted faults against it
    t0 = time.perf_counter()
    chk = lm_layer_check(cfg, params, check_batch)

    def count(*mixers):
        return sum(seg.count for seg in cfg.segments if seg.mixer in mixers)

    attending = count("gqa", "hybrid")
    want = {"attn": attending, "ssm": count("ssm", "hybrid"),
            "hybrid": count("hybrid"),
            "ssm_full": min(count("ssm", "hybrid"), 1),
            "state": min(count("ssm", "hybrid"), 1),
            "mlp": sum(seg.count for seg in cfg.segments
                       if seg.ffn == "mlp"),
            "flash": attending}
    what = {"attn": "attention vs float32 (all positions)",
            "ssm": f"SSM vs the float32 recurrence (first {SSM_CHECK} "
                   "positions)",
            "ssm_full": "the first SSM layer vs the float32 recurrence "
                        f"(all {LM_PROMPT} positions)",
            "state": "the first SSM layer's final state vs the float32 "
                     "recurrence's (a row per batch and head)",
            "hybrid": f"fused hybrid output vs float32 (first {SSM_CHECK} "
                      "positions)",
            "mlp": "MLP vs float32",
            "flash": "flash kernel vs its plain version"}
    for kind, n in want.items():
        rows = chk[kind]
        if len(rows) != n:
            fail(f"{arch}: the check measured {len(rows)} {kind} rows of "
                 f"{n} layers")
        if rows:
            log(f"{tag} {what[kind]}: row error max {max(rows):.3g} (limit "
                f"{FLASH_ROW_REL}), median {sorted(rows)[len(rows) // 2]:.3g}"
                f", layer by layer {[round(r, 5) for r in rows]}")
        if rows and max(rows) > FLASH_ROW_REL:
            fail(f"{arch}: {kind} rows differ: {rows}")
    log(f"{tag} layer check {time.perf_counter() - t0:.1f}s")
    for name, (model, stop, (obj, attr, fault), kind) in \
            new_planted_faults().items():
        if model != arch:
            continue
        with mock.patch.object(obj, attr, fault):
            got = lm_layer_check(cfg, params, check_batch, stop_after=stop)
        err = got[kind][-1]
        seen = {k: round(v[-1], 5) for k, v in got.items() if v}
        log(f"{tag} planted fault, {name}: layer {stop}'s {kind} row error "
            f"{err:.3g} (limit {FLASH_ROW_REL}) -> fails the check; every "
            f"kind at that layer {seen}")
        if err <= FLASH_ROW_REL:
            fail(f"{arch}: the float32 layer check passes a planted fault "
                 f"({name})")

    if cfg.mrope_sections is not None:
        def run(b_):
            return T.prefill(cfg, params, b_,
                             T.init_cache(cfg, LM_BATCH, LM_CACHE))[0]
        mrope, again, flat = run(check_batch), run(check_batch), run(batch)
        rel = float((mrope - flat).norm() / flat.norm())
        same = torch.equal(mrope, again)
        finite = bool(torch.isfinite(mrope).all())
        log(f"{tag} M-RoPE prefill (positions (3, {LM_BATCH}, {LM_PROMPT}):"
            f" {MROPE_TEXT} text, a {MROPE_GRID}x{MROPE_GRID} patch grid, "
            f"text): logits finite {finite}, {rel:.4g} (rel L2) from the "
            f"plain-RoPE prefill of the same embeds (at least "
            f"{MROPE_MIN_REL}); two runs the same bits = {same}")
        if not (same and finite) or rel < MROPE_MIN_REL:
            fail(f"{arch}: the M-RoPE prefill repeats {same}, is finite "
                 f"{finite}, moves {rel:.4g} from plain RoPE")
        del mrope, again, flat
    if attending:
        flash_at_model_shape(tag, cfg)

    served = serve_requests(tag, cfg, params, prompts, seed,
                            flash_layers=attending, new=NEW_ARCHS_NEW)
    st, greedy = served["stats"], served["greedy"]
    step_ms = st["decode_s"] / st["decode_steps"] * 1e3
    last = cfg.segments[-1]
    lt = layer_times(cfg, params, batch)
    ffn = f", FFN {lt['ffn']:.3f} ms" if "ffn" in lt else ""
    log(f"{tag} one {last.mixer}+{last.ffn} layer (window {last.window}) "
        f"on the prefill's inputs (device, CUDA events): mixer "
        f"{lt['mixer']:.3f} ms{ffn}; x {cfg.n_layers} layers "
        f"{sum(lt.values()) * cfg.n_layers / 1e3:.4f} s of the prefill's "
        f"{st['prefill_s']:.4f} s")
    caches = T.init_cache(cfg, LM_BATCH, LM_CACHE)
    T.prefill(cfg, params, batch, caches)
    tok = torch.zeros((LM_BATCH, cfg.d_model), device="cuda") if embeds \
        else torch.as_tensor(greedy[:, 0], device="cuda")
    for _ in range(2):         # the second trace: the first pays set-up
        busy = device_busy(
            lambda: T.decode_step(cfg, params, tok, caches, LM_PROMPT))
    del caches
    log(f"{tag} one decode step at position {LM_PROMPT}: "
        f"{busy['device_events']} device events, the device busy "
        f"{busy['busy_us'] / 1e3:.3f} ms of {busy['wall_us'] / 1e3:.3f} ms "
        f"wall (busy share {busy['busy_us'] / busy['wall_us']:.3f}); "
        f"reading the {n_params * 2 / 1e9:.3f} GB of weights once a step "
        f"bounds it at {n_params * 2 / PEAK_BYTES_PER_S * 1e3:.3f} ms at "
        f"3.35 TB/s; measured {step_ms:.3f} ms/step")
    del params
    return served["launches"]


def phase17_new_models(seed: int) -> dict:
    """Phase 17: the four models one after the other, the card freed
    between them; returns each one's kernel launches per generate."""
    import torch
    out = {}
    for arch in NEW_ARCHS:
        t0 = time.perf_counter()
        out[arch] = new_model(arch, seed)
        torch.cuda.empty_cache()
        log(f"[phase 17] {arch} {time.perf_counter() - t0:.1f}s, device "
            f"memory in use after freeing it "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return out


# --------------------------------------------------------------------------
# phase 18: LM training
# --------------------------------------------------------------------------

def train_truth_loss(cfg, w: dict, tokens, labels):
    """The float32 loss of a dense GQA model with internlm2's layers,
    written apart from the port, for autograd: the embedding row, then
    each layer's RMSNorm, RoPE (float64 angles), GQA with a full causal
    softmax over every position, SwiGLU, and the full-vocab cross-entropy
    of the final norm's logits. ``w`` maps the port's parameter names to
    float32 tensors."""
    import math

    import torch
    import torch.nn.functional as F
    b, s = tokens.shape
    dev = tokens.device
    h_, kv, hd, eps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.norm_eps
    half = cfg.rotary_dim // 2
    inv = cfg.rope_theta ** (-torch.arange(half, device=dev,
                                           dtype=torch.float64) / half)
    ang = torch.arange(s, device=dev, dtype=torch.float64)[:, None] * inv
    cos, sin = (f(ang).float()[None, :, None] for f in (torch.cos, torch.sin))

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:2 * half]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos,
                          t[..., 2 * half:]], dim=-1)

    later = ~torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    x = w["embed"][tokens]
    for j in range(cfg.segments[0].count):
        p = lambda n: w[f"segments.0.{j}.{n}"]
        h = rms_f32(x, p("ln1"), eps)
        q = rope((h @ p("mixer.wq")).view(b, s, h_, hd))
        k = rope((h @ p("mixer.wk")).view(b, s, kv, hd))
        v = (h @ p("mixer.wv")).view(b, s, kv, hd)
        k, v = (t.repeat_interleave(h_ // kv, dim=2) for t in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        pr = torch.softmax(sc.masked_fill(later, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, s, h_ * hd)
        x = x + o @ p("mixer.wo")
        x = x + swiglu_f32(rms_f32(x, p("ln2"), eps), p("ffn.wg"),
                           p("ffn.wu"), p("ffn.wd"))
    logits = rms_f32(x, w["final_ln"], eps).reshape(b * s, -1) @ w["head"]
    return F.cross_entropy(logits, labels.reshape(-1))


def train_check(cfg, model, batch, truth) -> tuple[float, float, str]:
    """The port's bf16 ``lm_loss`` and float32 master gradients on
    ``batch`` against ``truth`` = (loss, {name: gradient}): the loss's
    relative error and the worst leaf's relative L2 error, and its name."""
    from repro_torch.models import transformer as T
    for p in model.parameters():
        p.grad = None
    loss, _ = T.lm_loss(cfg, model, batch)
    loss.backward()
    loss_err = abs(float(loss.detach()) - truth[0]) / abs(truth[0])
    errs = {n: float((p.grad - truth[1][n]).norm()
                     / truth[1][n].norm().clamp_min(1e-30))
            for n, p in model.named_parameters()}
    worst = max(errs, key=errs.get)
    return loss_err, errs[worst], worst


def train_planted_faults() -> dict:
    """Context managers that plant a fault in the training path: the
    flash backward without its causal mask, dk and dv of each kv head
    taken from its group's first query head only (not summed over the
    group), and the cross-entropy against labels one position off."""
    import contextlib
    from unittest import mock

    import torch

    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T
    bwd, nll = ref.flash_attention_bwd_ref, T._chunk_nll

    def no_mask(q, k, v, do, **kw):
        return bwd(q, k, v, do, **{**kw, "causal": False})

    def first_head(q, k, v, do, **kw):
        rep = q.shape[2] // k.shape[2]
        dq, dk, dv = bwd(q, k.repeat_interleave(rep, dim=2),
                         v.repeat_interleave(rep, dim=2), do, **kw)
        return dq, dk[:, :, ::rep].contiguous(), dv[:, :, ::rep].contiguous()

    def shifted(hc, lc, head):
        return nll(hc, torch.roll(lc, 1), head)

    return {
        "flash backward without the causal mask":
            lambda: mock.patch.object(ref, "flash_attention_bwd_ref",
                                      no_mask),
        "dk, dv not summed over the GQA group":
            lambda: mock.patch.object(ref, "flash_attention_bwd_ref",
                                      first_head),
        "CE labels off by one position":
            lambda: mock.patch.object(T, "_chunk_nll", shifted),
        "none": contextlib.nullcontext,
    }


def train_full_depth(cfg, seed: int) -> dict:
    """TRAIN_STEPS steps of ``Trainer`` at full width and depth; the
    flash launches of every step; then one more step split into forward,
    backward and optimizer."""
    import math
    import statistics

    import torch

    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig, apply_updates
    from repro_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                          masters=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters, the config counts {cfg.param_count()}")
    log(f"[phase 18] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"H={cfg.n_heads}/{cfg.n_kv_heads}, hd={cfg.head_dim}, d_ff="
        f"{cfg.d_ff}, vocab={cfg.vocab_size}: {n_params} float32 masters "
        f"drawn on the card in {time.perf_counter() - t0:.2f}s; compute "
        f"{cfg.dtype}, remat {cfg.remat!r}, attn_chunk {cfg.attn_chunk}, "
        f"loss_chunk {cfg.loss_chunk}")
    data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, seed=seed)
    tcfg = TrainConfig(opt=OptConfig(**TRAIN_OPT), log_every=1000)
    trainer = Trainer(cfg, tcfg, model, iter(data))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        m = trainer.run(1)
        m["launches"] = ops.launch_counts()["flash_attention"]
        steps.append(m)
        log(f"[phase 18] step {i + 1}: loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.6f} lr {m['lr']:.3e} {m['step_time_s']:.4f}s "
            f"flash launches {m['launches']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in steps]
    vals = losses + [m["grad_norm"] for m in steps]
    if not all(map(math.isfinite, vals)):
        fail(f"a training loss or grad norm is not finite: {vals}")
    if not losses[-1] < losses[0]:
        fail(f"step {TRAIN_STEPS}'s loss {losses[-1]} is not below step "
             f"1's {losses[0]}")
    want = 2 * cfg.n_layers if cfg.remat != "none" else cfg.n_layers
    launches = {m["launches"] for m in steps}
    if launches != {want}:
        fail(f"flash launches a step {sorted(launches)}, expected {want} "
             f"(a forward a layer, and its remat recompute)")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(m["step_time_s"] for m in steps[2:])
    embed = cfg.vocab_size * cfg.d_model
    pairs = visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True, None)
    attn = 3 * 4.0 * cfg.head_dim * pairs * TRAIN_BATCH * cfg.n_heads \
        * cfg.n_layers
    flops = 6.0 * (n_params - embed) * tokens + attn
    bound_s = flops / PEAK_BF16_OPS_PER_S
    log(f"[phase 18] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} = "
        f"{tokens} tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f}; median "
        f"step of steps 3-{TRAIN_STEPS} {step_s:.4f}s, {tokens / step_s:.0f}"
        f" tokens/s; bound {bound_s:.4f}s (6 x {n_params - embed} "
        f"parameters less the embedding x {tokens} tokens + causal "
        f"attention {attn:.3g} FLOP at {PEAK_BF16_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s bf16; remat {cfg.remat!r} recomputes the forward, ~1/3 "
        f"more), {bound_s / step_s:.1%} of it; peak device memory "
        f"{peak:.3f} GiB; flash launches a step {want}")

    # one more step, split by host clock around synchronised parts
    named = dict(trainer.params.named_parameters())
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch_at(TRAIN_STEPS).items()}
    for p in named.values():
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = T.lm_loss(cfg, trainer.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    apply_updates(named, {n: p.grad for n, p in named.items()},
                  trainer.opt_state, tcfg.opt)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    split = {"forward_s": t1 - t0, "backward_s": t2 - t1,
             "optimizer_s": t3 - t2}
    log(f"[phase 18] one step split: forward {split['forward_s']:.4f}s, "
        f"backward {split['backward_s']:.4f}s (with the remat recompute), "
        f"optimizer {split['optimizer_s']:.4f}s")
    del trainer, model, named, loss, batch
    torch.cuda.empty_cache()
    return {"launches": want, "step_s": step_s, "bound_s": bound_s,
            "peak_gib": peak, "losses": losses, **split}


def train_float32_check(cfg, seed: int) -> dict:
    """One step at internlm2's width and TRAIN_CHECK_LAYERS layers on a
    TRAIN_CHECK_BATCH batch: the port's bf16 loss and float32 master
    gradients against ``train_truth_loss`` by autograd; then the planted
    faults against the same check; then ``apply_updates`` on these
    gradients on the card against the CPU."""
    import torch

    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_opt_state)

    if cfg.qkv_bias or cfg.qk_norm or cfg.segments[0].window:
        fail(f"{cfg.name}: the float32 truth has no QKV bias, QK norm or "
             "window")
    small = dataclasses.replace(cfg, segments=(dataclasses.replace(
        cfg.segments[0], count=TRAIN_CHECK_LAYERS),))
    model = T.init_params(small, torch.Generator("cuda").manual_seed(
        seed + 1), masters=True)
    b, s = TRAIN_CHECK_BATCH
    raw = SyntheticTokens(vocab_size=cfg.vocab_size, batch=b, seq_len=s,
                          seed=seed).batch_at(0)
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in raw.items()}
    w = {n: p.detach().clone().requires_grad_()
         for n, p in model.named_parameters()}
    truth_loss = train_truth_loss(small, w, batch["tokens"], batch["labels"])
    grads = torch.autograd.grad(truth_loss, list(w.values()))
    truth = (float(truth_loss.detach()), dict(zip(w, grads)))
    del grads
    out = {}
    for name, plant in train_planted_faults().items():
        with plant():
            loss_err, worst, leaf = train_check(small, model, batch, truth)
        out[name] = worst
        verdict = "passes" if max(worst, loss_err) <= TRAIN_GRAD_REL \
            else "fails"
        log(f"[phase 18] float32 check ({name}): loss {truth[0]:.6f}, rel "
            f"error {loss_err:.3g}; worst leaf {leaf} rel L2 {worst:.4g} "
            f"(limit {TRAIN_GRAD_REL}) -> {verdict}")
        if name == "none" and verdict == "fails":
            fail(f"the port's bf16 gradients are {worst:.4g} off the float32"
                 f" truth at {leaf} (loss {loss_err:.3g})")
        if name != "none" and verdict == "passes":
            fail(f"the float32 check passes a planted fault ({name})")
    grad_rows = {n: float((p.grad - truth[1][n]).norm()
                          / truth[1][n].norm().clamp_min(1e-30))
                 for n, p in model.named_parameters()}
    log(f"[phase 18] rel L2 by leaf: " + ", ".join(
        f"{n} {e:.3g}" for n, e in grad_rows.items()))

    # AdamW on the card against the CPU, on the same float32 gradients
    ocfg = OptConfig(**TRAIN_OPT)
    named = dict(model.named_parameters())
    grads = {n: p.grad for n, p in named.items()}
    cpu = {n: p.detach().cpu() for n, p in named.items()}
    cpu_grads = {n: g.cpu() for n, g in grads.items()}
    dev_state, cpu_state = init_opt_state(named, ocfg), \
        init_opt_state(cpu, ocfg)
    t0 = time.perf_counter()
    for _ in range(2):
        _, dev_state, dev_stats = apply_updates(named, grads, dev_state, ocfg)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(2):
        _, cpu_state, cpu_stats = apply_updates(cpu, cpu_grads, cpu_state,
                                                ocfg)
    t_cpu = time.perf_counter() - t0
    diff = max(max(float((named[n].detach().cpu() - cpu[n]).abs().max()),
                   float((dev_state.m[n].cpu() - cpu_state.m[n]).abs().max()),
                   float((dev_state.v[n].cpu() - cpu_state.v[n]).abs().max()))
               for n in named)
    log(f"[phase 18] apply_updates x 2 on the card ({t_dev:.3f}s) against "
        f"the CPU ({t_cpu:.3f}s), {sum(p.numel() for p in cpu.values())} "
        f"parameters: params, m, v max abs diff {diff:.3g} (limit "
        f"{TRAIN_OPT_TOL}); grad_norm {float(dev_stats['grad_norm']):.6f} "
        f"and {float(cpu_stats['grad_norm']):.6f}")
    if not diff <= TRAIN_OPT_TOL:
        fail(f"apply_updates on the card is {diff:.3g} off the CPU's")
    del model, named, grads, w, truth
    torch.cuda.empty_cache()
    return out


def train_flash_function() -> dict:
    """The flash Function alone at the training shape: its dq, dk, dv
    against autograd through the float32 plain version on the same inputs
    (bf16 row limit), the plain backward's ms beside its bound, and SDPA's
    forward + backward ms (a yardstick, never on the path)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    b, s, t, h, hkv, hd = FLASH_PATH
    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for shape in ((b, s, h, hd), (b, t, hkv, hd),
                                 (b, t, hkv, hd), (b, s, h, hd)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    chunk = ops.FLASH_BWD_CHUNK
    got = torch.autograd.grad(ops.flash_attention(*leaves), leaves, do)
    truth = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_bshd_ref(*truth), truth,
                               do.float())
    rows = {n: row_error(a, w) for n, a, w in zip(("dq", "dk", "dv"), got,
                                                   want)}
    err = max(float((a.float() - w).abs().max()) for a, w in zip(got, want))
    del truth, want, got
    torch.cuda.empty_cache()
    log(f"[phase 18] flash Function gradients at {FLASH_PATH} bf16 against "
        f"autograd through the float32 plain version: row errors "
        + ", ".join(f"{n} {e:.3g}" for n, e in rows.items())
        + f" (limit {FLASH_ROW_REL}), max abs {err:.3g}")
    if max(rows.values()) > FLASH_ROW_REL:
        fail(f"the flash Function's gradients differ: {rows}")
    bwd_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, do, chunk=chunk), iters=10)
    pairs = visible_pairs(s, t, True, None)
    bwd_ops = 5 * 2.0 * hd * pairs * b * h
    bwd_bytes = 2 * (2 * b * s * h * hd + 2 * b * t * hkv * hd) * 2
    bound_ms, bound_by = bound(bwd_bytes, bwd_ops, PEAK_BF16_OPS_PER_S)
    ours_ms = time_ms(lambda: torch.autograd.grad(ops.flash_attention(
        *leaves), leaves, do), iters=10)
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True), (qt, kt, vt), dot),
        iters=10)
    log(f"[phase 18] flash backward (plain, chunk {chunk}): "
        f"{bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: five causal "
        f"products of {bwd_ops / 5:.3g} FLOP at "
        f"{PEAK_BF16_OPS_PER_S / 1e12:.0f} TFLOP/s), {bound_ms / bwd_ms:.1%}"
        f" of it; the kernel's forward + plain backward {ours_ms:.4f} ms; "
        f"SDPA forward + backward {sdpa_ms:.4f} ms")
    return {"bwd_ms": bwd_ms, "bwd_bound_ms": bound_ms, "fwd_bwd_ms": ours_ms,
            "sdpa_fwd_bwd_ms": sdpa_ms}


def train_restart(seed: int) -> None:
    """Restart on the card at smoke size (bf16, remat "full", so the flash
    Function runs): 3 steps, a checkpoint, 2 more; a fresh Trainer from
    other weights restores and runs the same 2 steps."""
    import torch

    from repro_torch import configs
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(configs.smoke_config(TRAIN_ARCH),
                              dtype="bfloat16", remat="full")
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=1),
                           checkpoint_every=3, checkpoint_dir=tmp,
                           log_every=1000)

        def trainer(s: int):
            data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=128, seed=seed)
            return Trainer(cfg, tcfg, T.init_params(
                cfg, torch.Generator("cuda").manual_seed(s), masters=True),
                iter(data)), data
        first, _ = trainer(seed)
        first.run(3)
        after = [first.run(1)["loss"] for _ in range(2)]
        second, data = trainer(seed + 7)
        if not second.restore() or second.step != 3:
            fail("the restarted trainer did not restore step 3")
        data.step = second.step
        again = [second.run(1)["loss"] for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(again, after))
    log(f"[phase 18] restart at smoke size: steps 4-5 losses {after} "
        f"before, {again} after restoring step 3: "
        f"{'the same bits' if again == after else f'rel diff {rel:.3g}'} "
        f"(limit {TRAIN_RESTART_REL}: the backward's sums on the card, "
        f"cuBLAS's and the embedding's, keep their order between runs)")
    if rel > TRAIN_RESTART_REL:
        fail(f"the restarted losses {again} differ from {after}")


def phase18_train(seed: int) -> dict:
    """Phase 18: internlm2-1.8b trains at full width and depth; the float32
    check of one step with its planted faults; the flash Function alone;
    AdamW on the card against the CPU; a restart. Returns the flash
    launches a training step and the measurements."""
    import torch

    from repro_torch import configs
    cfg = configs.get_config(TRAIN_ARCH)
    out = {}
    for name, part in (("full", lambda: train_full_depth(cfg, seed)),
                       ("check", lambda: train_float32_check(cfg, seed)),
                       ("flash", train_flash_function),
                       ("restart", lambda: train_restart(seed))):
        t0 = time.perf_counter()
        out[name] = part()
        torch.cuda.empty_cache()
        log(f"[phase 18] {name}: {time.perf_counter() - t0:.1f}s")
    return out


# --------------------------------------------------------------------------
# phases 19 and 20: the LM on a mesh (FSDP×TP, models/sharding.py)
# --------------------------------------------------------------------------

def lm_greedy(cfg, params, prompts, new: int, caches_out=None):
    """Greedy tokens (B, new) and each step's float32 logits (new, B, V)
    on the card: the prefill, then ``new − 1`` decode steps (``Engine``'s
    loop), on one card or on a mesh (DTensor logits made whole). The
    caches after the last step are appended to ``caches_out`` if given."""
    import torch

    from repro_torch.models import transformer as T
    layout = T.layout_of(params)
    b, p = prompts.shape
    caches = T.init_cache(cfg, b, p + new, device=prompts.device,
                          mesh=None if layout is None else layout.mesh)

    from repro_torch.models.sharding import whole
    logits, caches = T.prefill(cfg, params, {"tokens": prompts}, caches)
    steps = [whole(logits).float()]
    toks = [steps[0].argmax(-1)]
    for i in range(new - 1):
        logits, caches = T.decode_step(cfg, params, toks[-1], caches, p + i)
        steps.append(whole(logits).float())
        toks.append(steps[-1].argmax(-1))
    if caches_out is not None:
        caches_out.append(caches)
    return torch.stack(toks, 1), torch.stack(steps)


def greedy_over(got, want) -> dict:
    """The mesh's greedy tokens and logits against one card's: the worst
    step's logits (relative L2, over the rows still compared), the rows
    that parted at a near-tie (row, step, one card's top-2 margin), and
    the figures over their limits (what, figure, limit): a step's logits
    over MESH_LOGIT_REL; a token unlike one card's where one card's top
    two logits are further apart than twice that row's largest logit
    difference. A row is not compared after it parts."""
    import torch
    toks, logits = got
    want_toks, want_logits = want
    worst, ties, over = 0.0, [], []
    live = torch.ones(toks.shape[0], dtype=torch.bool, device=toks.device)
    for i in range(toks.shape[1]):
        rows = live.nonzero()[:, 0]
        if rows.numel() == 0:
            break
        a, b = logits[i, rows], want_logits[i, rows]
        rel = float((a - b).norm() / b.norm())
        worst = max(worst, rel)
        if rel > MESH_LOGIT_REL:
            over.append((f"step {i}'s logits against one card's", rel,
                         MESH_LOGIT_REL))
        for r in rows.tolist():
            if int(toks[r, i]) == int(want_toks[r, i]):
                continue
            top2 = torch.topk(want_logits[i, r], 2).values
            margin = float(top2[0] - top2[1])
            noise = float((logits[i, r] - want_logits[i, r]).abs().max())
            if margin > 2 * noise:
                over.append((f"row {r} step {i}: token {int(toks[r, i])} "
                             f"against one card's {int(want_toks[r, i])}, "
                             f"one card's top-2 margin against twice the "
                             f"row's largest logit difference", margin,
                             2 * noise))
            ties.append((r, i, margin))
            live[r] = False
    return {"logit_rel": worst, "ties": ties, "over": over}


def hold_greedy(tag: str, got, want, gate: bool = True) -> dict:
    """``greedy_over``'s figures printed; any over its limit fails, unless
    ``gate`` is False (then they are printed alone)."""
    res = greedy_over(got, want)
    ties = res["ties"]
    log(f"{tag}: greedy tokens {'equal' if not ties else 'equal up to '}"
        f"{'' if not ties else ties} (row, step, one card's top-2 margin); "
        f"worst step logits relative L2 {res['logit_rel']:.3g} (limit "
        f"{MESH_LOGIT_REL}{'' if gate else ', printed'})"
        + (f"; over the limits{'' if gate else ' (printed)'}: "
           f"{res['over']}" if res["over"] else ""))
    if gate and res["over"]:
        fail(f"{tag}: over the limits: {res['over']}")
    return res


def hold_serving(tag: str, cfg, r0: dict) -> dict:
    """Rank 0's greedy serving of the full model sharded: held by
    ``hold_greedy`` against one card routed as the mesh routed (a model
    with MoE layers; one card's own run for any other); beside it, the
    same figures against one card routing by its own router, printed,
    with the prompt tokens x MoE layers routed to other experts than that
    card's. The prefill's calls come first, one a MoE layer: the first
    MoE layer's input is formed alike by the two runs, so its reroutes
    must be near-ties (ROUTE_TIE_ULPS); the later layers' inputs part
    further with depth (printed)."""
    sv = r0["serve"]
    what = f"{MESH_LM_PROMPT[0]} x {MESH_LM_PROMPT[1]} + {MESH_LM_NEW} tokens"
    n_moe = sum(seg.count for seg in cfg.segments if seg.ffn == "moe")
    routed = bool(sv["mesh_routes"])
    res = hold_greedy(f"{tag} {cfg.name} prefill + decode, {what}, against "
                      f"one card "
                      + ("routed as the mesh" if routed else "alone"),
                      sv["got"], sv["want"])
    if not routed:
        return res
    free = hold_greedy(f"{tag} {cfg.name} prefill + decode, {what}, against "
                       f"one card routing by its own router",
                       sv["got"], sv["free"], gate=False)
    first = routing_against(sv["mesh_routes"][:1], sv["routes"][:1])
    rt = routing_against(sv["mesh_routes"][:n_moe], sv["routes"][:n_moe])
    log(f"{tag} sharded serving: greedy generate {r0['serve_s']:.3f}s with "
        f"{r0['serve_launches']} flash launches; against one card's own "
        f"router: in the first MoE layer {first['moved']} of "
        f"{first['tokens']} prompt tokens routed to other experts, the worst "
        f"across a margin of {first['worst_ulps']:.3g} bf16 ulps, "
        f"{first['not_tie']} of them off a near-tie (over {ROUTE_TIE_ULPS} "
        f"ulps; limit 0); over all {n_moe} MoE layers {rt['moved']} of "
        f"{rt['tokens']} prompt tokens x layers "
        f"({rt['moved'] / rt['tokens']:.3%}) (printed: the layers before "
        f"part the two runs' inputs), its logits {free['logit_rel']:.3g} "
        f"from the mesh's (printed); collectives {r0['serve_collectives']}")
    if first["not_tie"]:
        fail(f"{tag} sharded serving routes {first['not_tie']} prompt tokens "
             f"of the first MoE layer unlike one card off a near-tie (limit "
             f"0)")
    return dict(res, free_logit_rel=free["logit_rel"],
                rerouted=rt["moved"] / rt["tokens"])


def first_layers(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers, each segment keeping its
    kind, width and window (deepseek-moe-16b's dense layer 0, then MoE
    layers; a dense model's ``dense_segments(n)``)."""
    import dataclasses as dc
    segs, left = [], n
    for seg in cfg.segments:
        if left:
            segs.append(dc.replace(seg, count=min(seg.count, left)))
            left -= segs[-1].count
    return dc.replace(cfg, segments=tuple(segs))


@contextlib.contextmanager
def routes_as(routes, keep: list):
    """``layers.moe_route`` wrapped to append each call's (expert ids (B,
    S, k) int16, router logits (B, S, E) in the compute dtype) to ``keep``
    on the host, and, given ``routes`` (a list of expert ids, one a call),
    to route call i to ``routes[i]``'s experts, with gates from its own
    probabilities there, renormalised as ``moe_route`` does."""
    import torch

    from repro_torch.models import layers as L
    right = L.moe_route

    def routed(cfg, p, x):
        probs, gates, eidx = right(cfg, p, x)
        with torch.no_grad():
            logits = x @ p.router      # moe_route's product, again
        keep.append((eidx.to(torch.int16).cpu(), logits.cpu()))
        if routes is not None:
            eidx = routes[len(keep) - 1].to(eidx.device, torch.int64)
            gates = probs.gather(-1, eidx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return probs, gates, eidx
    with _patched(L, "moe_route", routed):
        yield


def batch_routes(all_routes: list) -> list:
    """The mesh's routing of the whole batch, call by call: each batch
    group's (model rank 0's) expert ids and router logits, concatenated
    over the batch in data order, from every rank's (coord, digests,
    [(expert ids, logits)])."""
    import torch
    groups = sorted((c[0], r) for c, _, r in all_routes if c[1] == 0)
    return [tuple(torch.cat(parts) for parts in zip(*calls))
            for calls in zip(*(r for _, r in groups))]


def routing_against(mesh_routes: list, one_routes: list) -> dict:
    """The mesh's routing against one card's own, over the MoE calls of
    the two lists (each (expert ids, router logits) a call): the tokens
    whose top-k set differs, the worst margin they cross in bf16 ulps
    (one card's logit of an expert it picks and the mesh drops, less its
    logit of an expert the mesh picks in its place, the largest such
    difference, over the ulp at the pair's larger logit), and the ones off
    a near-tie (that margin above ROUTE_TIE_ULPS)."""
    import torch
    moved = not_tie = total = 0
    worst = 0.0
    for (e, _), (e1, l1) in zip(mesh_routes, one_routes):
        mine = torch.zeros(l1.shape, dtype=torch.bool).scatter_(
            -1, e.long(), True)
        one = torch.zeros(l1.shape, dtype=torch.bool).scatter_(
            -1, e1.long(), True)
        l1 = l1.float()
        diff = (one & ~mine).any(-1)
        dropped = torch.where(one & ~mine, l1, -torch.inf).amax(-1)[diff]
        taken = torch.where(mine & ~one, l1, torch.inf).amin(-1)[diff]
        size = torch.maximum(dropped.abs(), taken.abs()).clamp_min(1e-30)
        ulps = (dropped - taken) / torch.exp2(torch.floor(torch.log2(size))
                                              - 7)
        moved += int(diff.sum())
        not_tie += int((ulps > ROUTE_TIE_ULPS).sum())
        if ulps.numel():
            worst = max(worst, float(ulps.max()))
        total += diff.numel()
    return {"moved": moved, "not_tie": not_tie, "tokens": total,
            "worst_ulps": worst}


def fault_applies(kind: str, res: dict) -> bool:
    """Whether a planted fault of ``kind`` reaches the sharded step that
    ``res`` describes: "seq" faults need the residual split over the
    sequence, "moe" faults an MoE split over its experts, "mla" faults
    an MLA split over its heads, "attn" faults a GQA split over its
    heads, "ssm" faults an SSM split over its heads."""
    return {"any": True, "seq": res["seq_split"],
            "moe": res["moe_split"], "mla": res["mla_split"],
            "attn": res["attn_split"], "ssm": res["ssm_split"]}[kind]


def ssm_bc_part(cfg, name: str):
    """(dim, start, count) of the B and C columns of an SSM's w_in and of
    the B and C channels of its conv_w and conv_b; None for any other
    parameter. Every model rank of a split SSM computes B and C alike for
    its own heads, and their gradient, a small share of each of these
    leaves' (dt·x is small), is held on its own."""
    leaf = name.rsplit(".", 1)[-1]
    if cfg.ssm is None or leaf not in ("w_in", "conv_w", "conv_b"):
        return None
    sc = cfg.ssm
    di = sc.d_inner(cfg.d_model)
    return (-1, 2 * di if leaf == "w_in" else di,
            2 * sc.n_groups * sc.d_state)


def lm_mesh_rank(spec: dict) -> dict:
    """One rank of an LM mesh world (phase 19: gloo, ranks sharing card 0;
    phases 20-21: NCCL, a card each), on a (data, model) mesh:

      check  with ``check_layers``: a model of the architecture's first
             ``check_layers`` layers at its width: one sharded train step
             (``launch.specs.build_cell``'s step, masters drawn on the card
             from the seed by every rank, each keeping its shard) against
             the unsharded step that rank 0 runs on its own card first: the
             loss, every gradient leaf and every AdamW update, gathered
             leaf by leaf, and a digest of every MoE call's expert ids on
             every rank; then each planted fault of ``MESH_FAULTS`` whose
             kind is in ``faults`` and reaches the step
      serve  with ``prompt``: greedy prefill + decode of a
             ``serve_layers``-layer model (None: full depth) sharded,
             against the one-card model (rank 0, its card): for a model
             with MoE layers, the one card routed as the mesh routed
             (every MoE call's expert ids gathered to rank 0), and beside
             it the one card routing by its own router, with every MoE
             call's expert ids of both; every rank's tokens; with
             ``hold_caches``, each cache buffer after the last step
             gathered to rank 0 against one card's, a layer at a time;
             then each planted serving fault of ``MESH_FAULTS`` (kind
             "serve") on the same sharded model, the same figures
      generate  with ``generate`` (batch, prompt, new): the full-depth
             model (bf16, drawn from the seed, sharded) serves random
             prompts through ``Engine.generate``: its stats, flash
             launches, tokens, the collectives of the prefill and of the
             first decode step by kind, peak memory
      train  with ``train_steps``: the full-depth model trains that many
             steps through ``Trainer`` (float32 masters from the seed, the
             sharded step by ``step_fn=``): each step's loss, grad norm,
             seconds, flash launches and collective bytes; peak memory

    Returns rank 0's comparisons and every rank's timings and memory."""
    import dataclasses as dc
    import hashlib
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import SHAPES
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_opt_state)
    from repro_torch.train.trainer import TrainConfig, Trainer

    require_built()
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(spec["mesh"], ("data", "model"), device_type="cuda")
    coord = tuple(mesh.get_coordinate())
    full = configs.get_config(spec["arch"])
    b, s_len = spec["batch"], spec["seq"]
    tcfg = TrainConfig(opt=OptConfig(**TRAIN_OPT), log_every=1000)
    shape = dc.replace(SHAPES["train_4k"], seq_len=s_len, global_batch=b)
    out = {"rank": rank, "device": str(dev), "coord": coord}

    def gen():
        return torch.Generator(dev).manual_seed(spec["seed"])

    t_part = [time.perf_counter()]

    def done(what):
        """Rank 0 logs the seconds since the last part ended."""
        now = time.perf_counter()
        if rank == 0:
            log(f"[mesh world] {spec['arch']}: {what} "
                f"{now - t_part[0]:.1f}s")
        t_part[0] = now

    def split(model, kind):
        return kind in T.layout_of(model).split_blocks.values()

    # -- check: one step at full width, check_layers layers ----------------
    if spec["check_layers"]:
        cfg = first_layers(full, spec["check_layers"])
        data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=b,
                               seq_len=s_len, seed=spec["seed"])
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(0).items()}
        step, _, _ = specs.build_cell(cfg, shape, mesh, train=tcfg)
        world = dist.get_world_size()

        def one_card_step(routes=None):
            """Rank 0's unsharded step on its own card, routing each MoE
            call as ``routes`` says (the mesh's expert ids, gates from its
            own probabilities there) or by its own router; its own
            routing kept."""
            one = T.init_params(cfg, gen(), masters=True, device=dev)
            named = dict(one.named_parameters())
            before = {n: p.detach().clone() for n, p in named.items()}
            own = []
            with routes_as(routes, own):
                _, _, m = step(one, init_opt_state(named, tcfg.opt), batch)
            return {"loss": float(m["loss"]), "before": before,
                    "grad": {n: p.grad for n, p in named.items()},
                    "after": {n: p.detach() for n, p in named.items()},
                    "routes": own}

        def sharded_step(leaves=("grad", "after", "first")):
            """The sharded step from the seed's draws: every rank's loss,
            MoE routing (digests; expert ids and router logits gathered to
            rank 0), and on rank 0 the step's ``leaves`` gathered whole
            (a planted fault's step gathers its gradients alone); the
            flash launches, whether the residual was split over the
            sequence, the experts, MLA's, GQA's and the SSM's heads over
            the model axis."""
            model = T.init_params(cfg, gen(), masters=True, mesh=mesh,
                                  batch_size=b, device=dev)
            seq = T.layout_of(model).sequence(s_len) is not None
            kinds = {k: split(model, k)
                     for k in ("moe", "mla", "gqa", "ssm")}
            named = dict(model.named_parameters())
            before = {n: p.to_local().detach().clone()
                      for n, p in named.items()}
            routes = []
            ops.reset_launch_counts()
            with routes_as(None, routes):
                _, _, m = step(model, init_opt_state(named, tcfg.opt), batch)
            launches = ops.launch_counts()["flash_attention"]
            losses = [None] * world
            dist.all_gather_object(losses, float(m["loss"]))
            digests = [hashlib.sha256(e.numpy().tobytes()).hexdigest()
                       for e, _ in routes]
            all_routes = [None] * world
            dist.all_gather_object(all_routes, (coord, digests, routes))
            got = {k: {} for k in leaves}
            local = {"grad": lambda n, p: p.grad.to_local(),
                     "after": lambda n, p: p.to_local(),
                     "first": lambda n, p: before[n]}
            for n, p in named.items():    # gathered leaf by leaf to rank 0
                for k in leaves:
                    got[k][n] = whole_on_rank0(local[k](n, p), p)
            del model, named, before
            torch.cuda.empty_cache()
            if rank == 0:
                got.update(loss=float(m["loss"]), rank_losses=losses,
                           routes=[(c, d) for c, d, _ in all_routes],
                           batch_routes=batch_routes(all_routes))
            return got, launches, seq, kinds

        def compare(got, want, one_routes):
            """Rank 0's figures of the sharded step ``got`` against the
            unsharded ``want``; the mesh's routing against one card's own
            (``one_routes``). A step gathered without its masters (a
            planted fault's) has the loss, routing and gradient figures
            alone."""
            def rel(x, y):
                return float((x - y).norm() / y.norm().clamp_min(1e-30))

            def grad_rel():
                """Every gradient leaf's, and an SSM's B and C parts'."""
                out = {n: rel(g, want["grad"][n])
                       for n, g in got["grad"].items()}
                for n, g in got["grad"].items():
                    part = ssm_bc_part(cfg, n)
                    if part is not None:
                        out[f"{n} (B and C)"] = rel(
                            g.narrow(*part), want["grad"][n].narrow(*part))
                return out
            if "after" not in got:
                return {"loss": got["loss"], "want_loss": want["loss"],
                        "rank_losses": got["rank_losses"],
                        "routes": got["routes"],
                        "routing": routing_against(got["batch_routes"],
                                                   one_routes),
                        "grad_rel": grad_rel()}
            first, after = got["first"], got["after"]
            # one card's AdamW on the sharded step's own gradients
            own = {n: w.clone() for n, w in first.items()}
            apply_updates(own, got["grad"], init_opt_state(own, tcfg.opt),
                          tcfg.opt)
            check = {
                "loss": got["loss"], "want_loss": want["loss"],
                "rank_losses": got["rank_losses"], "routes": got["routes"],
                "routing": routing_against(got["batch_routes"], one_routes),
                "same_draws": max(float((first[n] - want["before"][n])
                                        .abs().max()) for n in first),
                "grad_rel": grad_rel(),
                # a master drawn as zeros (a conv bias) is its update after
                # one step, which the sign noise above leaves ungated:
                # printed apart
                "master_rel": {n: rel(after[n], want["after"][n])
                               for n in first if bool(first[n].any())},
                "zero_init_master_rel": {
                    n: rel(after[n], want["after"][n])
                    for n in first if not bool(first[n].any())},
                "update_rel": {n: rel(after[n] - first[n],
                                      want["after"][n] - want["before"][n])
                               for n in first},
                "own_rel": {n: rel(after[n] - first[n], own[n] - first[n])
                            for n in first}}
            del own
            return check

        got, out["check_launches"], out["seq_split"], kinds = sharded_step()
        out["moe_split"], out["mla_split"] = kinds["moe"], kinds["mla"]
        out["attn_split"], out["ssm_split"] = kinds["gqa"], kinds["ssm"]
        want = one_routes = None
        if rank == 0:
            # one card routing by its own router: printed. The check holds
            # the step against one card routing as the mesh did (bf16 router
            # logits near a tie may pick another expert on either side:
            # ``routing`` holds those to near-ties). A model without MoE
            # layers routes nothing: the two are one step
            alone = one_card_step()
            one_routes = alone["routes"]
            indep = compare(got, alone, one_routes)
            if got["batch_routes"]:
                del alone
                torch.cuda.empty_cache()
                want = one_card_step([e for e, _ in got["batch_routes"]])
                out["check"] = compare(got, want, one_routes)
            else:
                # ``want`` is the step's one reference from here on, so
                # ``del want`` below frees it
                want, out["check"] = alone, dict(indep)
                del alone
            out["check"]["alone"] = {k: indep[k] for k in (
                "loss", "want_loss", "grad_rel", "master_rel")}
            del indep
        del got
        torch.cuda.empty_cache()
        done("the 2-layer check")
        # the planted faults of the sharded step: each must fail the check
        out["fault_kinds"], out["faults"] = spec["faults"], {}
        for name, (kind, plant) in MESH_FAULTS.items():
            if kind not in spec["faults"] or name in SERVE_PATH_FAULTS \
                    or not fault_applies(kind, out):
                continue
            with plant(mesh):
                got, _, _, _ = sharded_step(("grad",))
            if rank == 0:
                out["faults"][name] = compare(got, want, one_routes)
            del got
            torch.cuda.empty_cache()
            done(f"planted fault '{name}'")
        del want, batch
        torch.cuda.empty_cache()

    # -- serve: greedy prefill + decode, sharded against one card -----------
    if spec["prompt"] is not None:
        scfg = full if spec["serve_layers"] is None \
            else first_layers(full, spec["serve_layers"])
        prompts = torch.as_tensor(SyntheticTokens(
            vocab_size=scfg.vocab_size, batch=spec["prompt"][0],
            seq_len=spec["prompt"][1], seed=spec["seed"] + 1).batch_at(0)[
                "tokens"], device=dev)
        hold_caches = spec.get("hold_caches", False)
        # the cache rows the decode steps wrote, held on their own too
        decoded = slice(spec["prompt"][1], spec["prompt"][1] + spec["new"]
                        - 1) if spec.get("hold_decode_rows") else None
        free, free_routes, routes, one_caches = None, [], [], None
        if rank == 0:
            # one card routing by its own router, first: printed beside
            served = T.init_params(scfg, gen(), device=dev)
            kept = [] if hold_caches else None
            with routes_as(None, free_routes):
                free = lm_greedy(scfg, served, prompts, spec["new"], kept)
            if hold_caches:
                one_caches = {seg: {n: buf.cpu() for n, buf in bufs.items()}
                              for seg, bufs in kept[0].items()}
            del served, kept
            torch.cuda.empty_cache()

        def sharded_generate(model, keep_routes):
            """The greedy generate on the mesh: tokens and logits on the
            host; with ``hold_caches``, each cache buffer against one
            card's on rank 0, by layer and batch row (``cache_worst``)."""
            kept = [] if hold_caches else None
            with routes_as(None, keep_routes):
                res = lm_greedy(scfg, model, prompts, spec["new"], kept)
            res = tuple(t.cpu() for t in res)
            cache_rel = {}

            def worst_layer(got_, want_):
                """Relative L2 of each layer's batch row, [layer][row]."""
                diff = (got_ - want_).flatten(2)
                rel = diff.norm(dim=2) / want_.flatten(2).norm(
                    dim=2).clamp_min(1e-30)
                return rel.cpu().tolist()
            for seg, bufs in (kept[0].items() if hold_caches else ()):
                for name, buf in bufs.items():
                    mesh_buf = whole_on_rank0(buf.to_local(), buf)
                    if rank == 0:
                        one = one_caches[seg][name].to(dev).float()
                        cache_rel[f"{seg}.{name}"] = worst_layer(
                            mesh_buf.float(), one)
                        if decoded is not None and name in ("k", "v"):
                            cache_rel[f"{seg}.{name} decoded rows"] = \
                                worst_layer(mesh_buf[:, :, decoded].float(),
                                            one[:, :, decoded])
                    del mesh_buf
            tokens = [None] * dist.get_world_size()
            dist.all_gather_object(tokens, res[0])
            same = all(torch.equal(t, res[0]) for t in tokens)
            return {"got": res, "cache_rel": cache_rel,
                    "ranks_agree": same}

        served = T.init_params(scfg, gen(), mesh=mesh, device=dev)
        out["serve_seq_split"] = T.layout_of(served).sequence(
            spec["prompt"][1]) is not None
        ops.reset_launch_counts()
        sh.reset_collectives()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        clean = sharded_generate(served, routes)
        torch.cuda.synchronize(dev)
        out["serve_s"] = time.perf_counter() - t0
        out["serve_launches"] = ops.launch_counts()["flash_attention"]
        out["serve_collectives"] = sh.collective_counts()
        got = clean["got"]
        # the planted serving faults, each on the same sharded model
        out["serve_faults"] = {}
        for name, (kind, plant) in MESH_FAULTS.items():
            if name not in spec.get("serve_faults", ()):
                continue
            with plant(mesh):
                res = sharded_generate(served, [])
            if rank == 0:
                out["serve_faults"][name] = res
            done(f"planted serving fault '{name}'")
        del served
        torch.cuda.empty_cache()
        # the mesh's routing of the whole batch, call by call (the prefill's,
        # then each decode step's, one a MoE layer) on rank 0
        all_routes = [None] * dist.get_world_size()
        dist.all_gather_object(all_routes, (coord, None, routes))
        if rank == 0:
            mesh_routes = batch_routes(all_routes)
            want, as_mesh = free, []
            if mesh_routes:
                # the one card again, routed as the mesh routed: the gate
                served = T.init_params(scfg, gen(), device=dev)
                with routes_as([e for e, _ in mesh_routes], as_mesh):
                    want = lm_greedy(scfg, served, prompts, spec["new"])
                del served
                torch.cuda.empty_cache()
            out["serve"] = {"got": got,
                            "want": tuple(t.cpu() for t in want),
                            "free": tuple(t.cpu() for t in free),
                            "routes": free_routes,
                            "mesh_routes": mesh_routes,
                            "cache_rel": clean["cache_rel"],
                            "ranks_agree": clean["ranks_agree"]}
        del got, free, free_routes, routes, all_routes, clean, one_caches
        torch.cuda.empty_cache()
        done("greedy serving")

    # -- generate: full depth through Engine.generate -----------------------
    if spec.get("generate"):
        from repro_torch.serve.engine import Engine, ServeConfig
        gb, gp, gnew = spec["generate"]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = T.init_params(full, gen(), mesh=mesh, device=dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        prompts = torch.as_tensor(SyntheticTokens(
            vocab_size=full.vocab_size, batch=gb, seq_len=gp,
            seed=spec["seed"] + 2).batch_at(0)["tokens"], device=dev)
        engine = Engine(full, model, ServeConfig(cache_len=gp + gnew,
                                                 batch_size=gb), device=dev)
        engine.generate(prompts[:, :256], 2)                   # warm up
        calls = []

        def counted(fn):
            """``fn`` (the prefill or a decode step), each call's
            collectives by kind appended to ``calls``."""
            def run(*args, **kwargs):
                before = sh.collective_counts()
                res = fn(*args, **kwargs)
                after = sh.collective_counts()
                calls.append({k: {"count": after[k]["count"]
                                  - before[k]["count"],
                                  "bytes": after[k]["bytes"]
                                  - before[k]["bytes"]}
                              for k in after
                              if after[k]["count"] > before[k]["count"]})
                return res
            return run

        # the residual each layer takes, a shape a call (this tree's
        # split, seen from the layer: (B/dp, S/m, D) where it splits)
        carries = []
        hook = model.segments[0][0].register_forward_pre_hook(
            lambda mod, args: carries.append(tuple(args[0].shape)))
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        with _patched(T, "prefill", counted(T.prefill)), \
                _patched(T, "decode_step", counted(T.decode_step)):
            toks = engine.generate(prompts, gnew)
        hook.remove()
        gen_out = {"stats": dict(engine.last_stats),
                   "launches": ops.launch_counts()["flash_attention"],
                   "prefill_collectives": calls[0],
                   "decode_collectives": calls[1] if len(calls) > 1
                   else {},
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "init_s": init_s,
                   "n_params": sum(p.numel() for p in model.parameters()),
                   "local_bytes": sum(p.to_local().numel()
                                      * p.to_local().element_size()
                                      for p in model.parameters()),
                   "prefill_carry": carries[0],
                   "decode_carry": carries[1] if len(carries) > 1 else None}
        # this rank's K/V cache bytes of the generate (a split GQA's
        # HeadCache, or the channel shard of cache_specs)
        caches = T.init_cache(full, gb, gp + gnew, device=dev, mesh=mesh)
        gen_out["kv_bytes"] = sum(
            buf.to_local().numel() * buf.to_local().element_size()
            for bufs in caches.values() for n, buf in bufs.items()
            if n in ("k", "v"))
        del caches
        tokens = [None] * dist.get_world_size()
        dist.all_gather_object(tokens, toks)
        gen_out["ranks_agree"] = all(bool((t == toks).all())
                                     for t in tokens)
        gen_out["tokens_ok"] = bool(toks.shape == (gb, gnew)
                                    and toks.min() >= 0
                                    and toks.max() < full.vocab_size)
        out["generate"] = gen_out
        del engine, model
        torch.cuda.empty_cache()
        done("full-depth generate")

    # -- train: full depth, train_steps steps ------------------------------
    if spec["train_steps"]:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = T.init_params(full, gen(), masters=True, mesh=mesh,
                              batch_size=b, device=dev)
        torch.cuda.synchronize(dev)
        out["init_s"] = time.perf_counter() - t0
        out["train_moe_split"] = split(model, "moe")
        out["train_mla_split"] = split(model, "mla")
        out["train_batch"] = (b, s_len)
        out["n_params"] = sum(p.numel() for p in model.parameters())
        out["local_bytes"] = sum(p.to_local().numel() * 4
                                 for p in model.parameters())
        step, _, _ = specs.build_cell(full, shape, mesh, train=tcfg)
        trainer = Trainer(full, tcfg, model, iter(SyntheticTokens(
            vocab_size=full.vocab_size, batch=b, seq_len=s_len,
            seed=spec["seed"])), step_fn=step, device=dev)
        steps = []
        for _ in range(spec["train_steps"]):
            ops.reset_launch_counts()
            sh.reset_collectives()
            retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                                       0)
            m = trainer.run(1)
            m["launches"] = ops.launch_counts()["flash_attention"]
            m["collectives"] = sh.collective_counts()
            # the caching allocator's frees and retries of a cudaMalloc
            # that failed (memory near full), a step
            m["alloc_retries"] = torch.cuda.memory_stats(dev).get(
                "num_alloc_retries", 0) - retries
            steps.append(m)
        out["steps"] = steps
        out["step_s"] = statistics.median(m["step_time_s"]
                                          for m in steps[2:])
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
        done(f"{spec['train_steps']} training steps")
        del trainer, model
        torch.cuda.empty_cache()
    return out


def lm_mesh_specs(specs: list) -> list:
    """``lm_mesh_rank`` for each spec in turn, in one world."""
    return [lm_mesh_rank(spec) for spec in specs]


def whole_on_rank0(local, p):
    """``local`` (this rank's shard of DTensor ``p``, or of an earlier
    value of it) made whole on rank 0 alone, None elsewhere: every rank's
    shard gathered to rank 0 (through the host in a gloo world) and put in
    place by its mesh coordinate. A collective every rank joins; rank 0
    alone receives, where an all-gather makes every rank whole."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.sharding import HeadCache, local_slice
    if isinstance(p, HeadCache):
        # a split GQA's cache held by heads: every rank makes it whole
        full = p.whole()
        return full if dist.get_rank() == 0 else None
    mesh = p.device_mesh
    host = dist.get_backend() == "gloo" and local.is_cuda
    send = local.detach().contiguous()
    send = send.cpu() if host else send
    rank, world = dist.get_rank(), dist.get_world_size()
    parts = [torch.empty_like(send) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(send, parts, dst=0)
    if rank != 0:
        return None
    out = torch.empty(p.shape, dtype=local.dtype, device=local.device)
    for r, part in enumerate(parts):
        coord = [int(i) for i in (mesh.mesh == r).nonzero()[0]]
        local_slice(out, mesh, p.placements, coord).copy_(part)
    return out


# planted faults of the sharded train step (phases 19-20), each patched in
# for one sharded_check of lm_mesh_rank and held to fail mesh_check_over


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def fault_exit_twice(mesh):
    """The row-parallel exit reduced twice: the partial product summed
    over the model axis before the exit sums it again."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh
    right = L.row_parallel

    def twice(x, w, tp, plus=None):
        if not torch.is_grad_enabled():
            return right(x, w, tp, plus)
        y = x @ w if plus is None else x @ w + plus
        return tp.exit(sh._Exit.apply(y, tp))
    return _patched(L, "row_parallel", twice)


def fault_drop_data_share(mesh):
    """A gradient reduce-scatter over the data axis that drops one data
    rank's share (data rank 1 contributes zeros)."""
    from repro_torch.models import sharding as sh
    right, data = sh.reduce_scatter, mesh.get_group(0).group_name

    def dropping(t, group, n, dim, index):
        if group.group_name == data and index == 1:
            t = t.new_zeros(t.shape)
        return right(t, group, n, dim, index)
    return _patched(sh, "reduce_scatter", dropping)


def fault_wrong_columns(mesh):
    """Column shards mapped to the wrong model rank: each rank's attention
    computes with its neighbour's wq, wk and wv columns (its own wo
    rows)."""
    import torch

    from repro_torch.models import sharding as sh

    class Roll(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, group, n, index):
            ctx.args = (group, n, index)
            pieces = sh.all_gather(w[None], group, n, 0)
            return pieces[(index + 1) % n].contiguous()

        @staticmethod
        def backward(ctx, g):
            group, n, index = ctx.args
            pieces = sh.all_gather(g.contiguous()[None], group, n, 0)
            return pieces[(index - 1) % n].contiguous(), None, None, None

    right = sh.Layout.use

    def rolled(self, name, p, dtype, **kw):
        w = right(self, name, p, dtype, **kw)
        block = self.block_of(name)
        if block is None or self.split_blocks[block] != "gqa" \
                or name.rsplit(".", 1)[1] not in ("wq", "wk", "wv"):
            return w
        tp = self.tp_dim
        return Roll.apply(w, self.groups[tp], self.sizes[tp], self.coord[tp])
    return _patched(sh.Layout, "use", rolled)


def fault_sequence_order(mesh):
    """The sequence's parts gathered over the model axis in the wrong
    order (reversed)."""
    import torch

    from repro_torch.models import sharding as sh
    right = sh.ModelSplit.gather

    def reversed_parts(self, x):
        y = right(self, x)
        return torch.cat(y.split(x.shape[1], dim=1)[::-1], dim=1)
    return _patched(sh.ModelSplit, "gather", reversed_parts)


def fault_norm_not_summed(mesh):
    """The norms that run on this rank's part of the sequence take their
    gradient from that part alone (not summed over the model axis)."""
    from repro_torch.models import sharding as sh
    return _patched(sh, "_on_sequence_part", lambda name, blocks: False)


def fault_gold_not_summed(mesh):
    """The vocab-parallel loss's label logit taken from this rank's
    columns alone (not summed over the model axis)."""
    import torch

    from repro_torch.models import sharding as sh

    def local_gold(self, logits, local, mine):
        v = logits.shape[1]
        own = torch.gather(logits, 1, local.clamp(0, v - 1)[:, None])[:, 0]
        return torch.where(mine, own, 0.0)
    return _patched(sh.VocabSplit, "gold", local_gold)


def fault_experts_shifted(mesh):
    """Experts on the wrong model rank: each rank takes its expert shard
    for the next rank's experts (the local-expert offset shifted by one
    shard), so it runs the slots of experts whose weights it lacks."""
    from repro_torch.models import layers as L

    def shifted(p, tp):
        return (tp.index + 1) % tp.n * p.experts.wg.shape[0]
    return _patched(L, "first_expert", shifted)


def fault_routed_not_summed(mesh):
    """The routed partials not summed over the model axis: each rank keeps
    its own experts' output (its part of the sequence of it, where the
    residual is split), only the shared experts' partial crosses the
    axis."""
    from repro_torch.models import layers as L
    right = L.row_parallel

    def unsummed(x, w, tp, plus=None):
        out = right(x, w, tp)
        if plus is None:
            return out
        return out + (tp.part(plus) if tp.seq else plus).to(out.dtype)
    return _patched(L, "row_parallel", unsummed)


def fault_mla_wrong_heads(mesh):
    """MLA's w_uk and w_uv cut to the wrong model rank's heads: each rank
    takes its neighbour's heads' latent columns of the gathered weights
    (its own wq columns and wo rows)."""
    from repro_torch.models import sharding as sh
    right = sh.Layout._plan

    def shifted(self, name, *args, **kwargs):
        plan = right(self, name, *args, **kwargs)
        if plan.select is None or name.rsplit(".", 1)[1] not in ("w_uk",
                                                                "w_uv"):
            return plan
        dim, ((start, count),) = plan.select
        full = count * self.sizes[self.tp_dim]     # an even cut of the heads
        return dataclasses.replace(plan, select=(
            dim, (((start + count) % full, count),)))
    return _patched(sh.Layout, "_plan", shifted)


def fault_mla_latent_not_summed(mesh):
    """MLA's latent projection gradients not summed over the model axis:
    w_dkv and kv_ln, which every model rank uses alike, keep the gradient
    of this rank's heads alone."""
    from repro_torch.models import sharding as sh
    right = sh.Layout._plan

    def unsummed(self, name, *args, **kwargs):
        plan = right(self, name, *args, **kwargs)
        block = self.block_of(name)
        if block is None or self.split_blocks[block] != "mla" \
                or name.rsplit(".", 1)[1] not in ("w_dkv", "kv_ln"):
            return plan
        return dataclasses.replace(plan, partial=tuple(
            a for a in plan.partial if a != self.tp_dim))
    return _patched(sh.Layout, "_plan", unsummed)


def fault_vocab_order(mesh):
    """Serving's vocab-parallel logits assembled in the wrong model order:
    each model rank returns its neighbour's vocab shard's logits as its
    own."""
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as T
    right = T._logits

    def rolled(cfg, params, h):
        out = right(cfg, params, h)
        layout = T.layout_of(params)
        if layout is None or T._head_name(cfg) not in layout.vocab_parallel:
            return out
        tp = layout.tp_dim
        n, index = layout.sizes[tp], layout.coord[tp]
        parts = sh.all_gather(out[None].contiguous(), layout.groups[tp], n, 0)
        return parts[(index + 1) % n].contiguous()
    return _patched(T, "_logits", rolled)


def fault_last_part(mesh):
    """A split prefill's last position taken from the wrong sequence part:
    the last row of the first model rank's part, not the last rank's."""
    from repro_torch.models import transformer as T
    right = T._last_position

    def first_part(x, seq):
        if seq is None:
            return right(x, seq)
        return seq.gather(x[:, -1:].contiguous())[:, 0]
    return _patched(T, "_last_position", first_part)


def fault_cache_part(mesh):
    """A split prefill's K/V caches written from the wrong sequence part:
    each model rank writes its own part's keys and values at the prompt's
    first rows and leaves the rest of the prompt's rows zero (as a
    prefill that wrote its part without gathering the sequence)."""
    import torch

    from repro_torch.models import layers as L
    right = L.GQA.forward

    def own_part_first(self, x, cos, sin, *, cache=None, pos=None, tp=None,
                       **kwargs):
        out = right(self, x, cos, sin, cache=cache, pos=pos, tp=tp,
                    **kwargs)
        if cache is not None and pos == 0 and tp is not None and tp.seq:
            part = x.shape[1]                  # this rank's part's length
            with torch.no_grad():
                for buf in (cache["k"], cache["v"]):
                    mine = buf[:, tp.index * part:(tp.index + 1) * part] \
                        .clone()
                    buf[:, :tp.n * part] = 0
                    buf[:, :part] = mine
        return out
    return _patched(L.GQA, "forward", own_part_first)


def fault_kv_group_over(mesh):
    """A split GQA's query heads reading the KV head one group over: each
    model rank computes with the KV heads after its own (the deal of
    ``sharding.head_ranges`` shifted by one group, kept within the KV
    heads), its K/V cache holding those."""
    from repro_torch.models import sharding as sh
    right = sh.head_ranges

    def shifted(h, g, m, index):
        q0, qn, k0, kn = right(h, g, m, index)
        return q0, qn, (k0 + 1) % (g - kn + 1), kn
    return _patched(sh, "head_ranges", shifted)


def fault_kv_grad_one_rank(mesh):
    """A split GQA's KV weights keep this rank's part of their gradient
    alone (not summed over the model axis), so a KV head dealt to or
    shared by several ranks lacks the others' parts."""
    from repro_torch.models import sharding as sh
    right = sh.Layout._plan

    def unsummed(self, name, *args, **kwargs):
        plan = right(self, name, *args, **kwargs)
        block = self.block_of(name)
        if block is None or self.split_blocks[block] != "gqa" \
                or name.rsplit(".", 1)[1] not in sh._KV_LEAVES:
            return plan
        return dataclasses.replace(plan, partial=tuple(
            a for a in plan.partial if a != self.tp_dim))
    return _patched(sh.Layout, "_plan", unsummed)


def fault_decode_kv_slot(mesh):
    """A split GQA's decode step writing its K and V into another head's
    slot of the cache: the new rows of a rank that holds two or more KV
    heads land rolled by one head."""
    import torch

    from repro_torch.models import layers as L
    right = L.GQA.attend

    def rolled(self, x, cos, sin, *, cache=None, pos=None, **kwargs):
        out = right(self, x, cos, sin, cache=cache, pos=pos, **kwargs)
        if cache is not None and pos and self.tp is not None:
            hd, s = self.cfg.head_dim, x.shape[1]
            with torch.no_grad():
                for buf in (cache["k"], cache["v"]):
                    rows = buf[:, pos:pos + s]
                    rows.copy_(rows.roll(hd, -1))
        return out
    return _patched(L.GQA, "attend", rolled)


def fault_ssm_norm_not_summed(mesh):
    """A split SSM's gated norm over this rank's channels alone: the
    squares not summed over the model axis (``ModelSplit.total`` returns
    its input)."""
    from repro_torch.models import sharding as sh
    return _patched(sh.ModelSplit, "total", lambda self, t: t)


def fault_ssm_bc_grad_one_rank(mesh):
    """A split SSM's B and C gradients from model rank 0 alone: the other
    ranks drop their gradient of w_in's B and C columns and of the conv's
    B and C channels before the sum over the model axis."""
    import torch

    from repro_torch.models import sharding as sh

    class Drop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, start, width):
            ctx.cut = (start, width)
            return w.view_as(w)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g.narrow(-1, *ctx.cut).zero_()
            return g, None, None

    right = sh.Layout.use

    def dropped(self, name, p, dtype, **kw):
        w = right(self, name, p, dtype, **kw)
        block, leaf = self.block_of(name), name.rsplit(".", 1)[-1]
        if block is None or self.split_blocks[block] != "ssm" \
                or leaf not in ("w_in", "conv_w", "conv_b") \
                or self.coord[self.tp_dim] == 0:
            return w
        sc = self.cfg.ssm
        own = self.ssm_heads[self.coord[self.tp_dim]][1] * sc.head_dim
        # w_in's pieces [z | x | B | C | dt], the conv's [x | B | C]
        return Drop.apply(w, 2 * own if leaf == "w_in" else own,
                          2 * sc.n_groups * sc.d_state)
    return _patched(sh.Layout, "use", dropped)


def fault_ssm_decode_state_slot(mesh):
    """A split SSM's decode step writing its new state into another
    head's slot of the cache: the state a rank's decode step leaves lands
    rolled by one of its heads."""
    import torch

    from repro_torch.models import layers as L
    right = L.SSM.mix

    def rolled(self, x, *, cache=None, tp=None):
        out = right(self, x, cache=cache, tp=tp)
        if cache is not None and x.shape[1] == 1 and tp is not None:
            with torch.no_grad():
                cache["state"].copy_(cache["state"].roll(1, 1))
        return out
    return _patched(L.SSM, "mix", rolled)


#: name → (kind, plant(mesh)); kind "any", or "seq" (needs the residual
#: split over the sequence), "moe" (an MoE split over its experts), "mla"
#: (an MLA split over its heads), "attn" (a GQA split over its heads),
#: "ssm" (an SSM split over its heads):
#: faults of the sharded train step, held by its 2-layer check, but those
#: of SERVE_PATH_FAULTS, held by the serving check; or "serve": faults of
#: sharded serving (the vocab-parallel head, the split prefill), held by
#: phase 23's check
MESH_FAULTS = {
    "row-parallel exit reduced twice": ("any", fault_exit_twice),
    "gradient reduce-scatter drops data rank 1": ("any",
                                                  fault_drop_data_share),
    "column shards on the wrong model rank": ("any", fault_wrong_columns),
    "sequence parts gathered in the wrong order": ("seq",
                                                   fault_sequence_order),
    "norm gradients not summed over model": ("seq", fault_norm_not_summed),
    "vocab-parallel gold logit not summed": ("any", fault_gold_not_summed),
    "experts on the wrong model rank": ("moe", fault_experts_shifted),
    "routed partials not summed over model": ("moe",
                                              fault_routed_not_summed),
    "MLA heads' latent columns from the wrong model rank": (
        "mla", fault_mla_wrong_heads),
    "latent projection gradients not summed over model": (
        "mla", fault_mla_latent_not_summed),
    "vocab shards' logits in the wrong model order": ("serve",
                                                       fault_vocab_order),
    "last position from the wrong sequence part": ("serve",
                                                   fault_last_part),
    "prefill caches written from the wrong sequence part": (
        "serve", fault_cache_part),
    "query heads read the KV head one group over": ("attn",
                                                    fault_kv_group_over),
    "KV head gradients from one model rank only": ("attn",
                                                   fault_kv_grad_one_rank),
    "decode K/V written into another head's cache slot": (
        "attn", fault_decode_kv_slot),
    "SSM norm's squares not summed over model": ("ssm",
                                                 fault_ssm_norm_not_summed),
    "SSM B and C gradients from one model rank only": (
        "ssm", fault_ssm_bc_grad_one_rank),
    "decode SSM state written into another head's cache slot": (
        "ssm", fault_ssm_decode_state_slot),
}
#: the planted faults of a kind other than "serve" that only serving
#: reaches: run on the serving check (``lm_mesh_rank``'s ``serve_faults``)
SERVE_PATH_FAULTS = ("decode K/V written into another head's cache slot",
                     "decode SSM state written into another head's cache "
                     "slot")


def route_splits(c: dict) -> tuple[int, int]:
    """(MoE calls whose expert ids differ between the model ranks of a
    batch group, MoE calls digested on one rank), from the check's
    digests."""
    groups: dict = {}
    for coord, digests in c["routes"]:
        groups.setdefault(coord[0], []).append(digests)
    split = sum(len(set(calls)) > 1 for ranks in groups.values()
                for calls in zip(*ranks))
    return split, len(c["routes"][0][1])


def mesh_check_over(c: dict) -> list:
    """The check's figures over their limits: (what, figure, limit)."""
    over = []
    loss_rel = abs(c["loss"] - c["want_loss"]) / abs(c["want_loss"])
    if c.get("same_draws", 0.0) != 0.0:
        over.append(("init against one card's draws", c["same_draws"], 0.0))
    if loss_rel > MESH_LOSS_REL:
        over.append(("loss", loss_rel, MESH_LOSS_REL))
    # every rank reports the global loss: the same all-reduced sums, the
    # same bits (phase 20's training steps hold the same)
    spread = max(c["rank_losses"]) - min(c["rank_losses"])
    if spread != 0.0:
        over.append(("loss spread over the ranks", spread, 0.0))
    # the model ranks of a batch group route every token alike, and where
    # the mesh routes a token to other experts than one card, it is a tie
    split, _ = route_splits(c)
    if split:
        over.append(("MoE calls routed differently on a batch group's "
                     "model ranks", split, 0))
    if c["routing"]["not_tie"]:
        over.append(("tokens routed unlike one card off a near-tie",
                     c["routing"]["not_tie"], 0))
    for key, limit in (("grad_rel", MESH_GRAD_REL),
                       ("master_rel", MESH_MASTER_REL),
                       ("own_rel", MESH_OWN_REL)):
        over += [(f"{key} {n}", r, limit) for n, r in c.get(key, {}).items()
                 if r > limit]
    return over


def hold_mesh_check(tag: str, res: dict) -> None:
    """Rank 0's check: the sharded init the bits of one card's draws; the
    loss within MESH_LOSS_REL, every gradient leaf within MESH_GRAD_REL and
    every updated master within MESH_MASTER_REL of the unsharded step's
    (but a master drawn as zeros, whose first step leaves only its update,
    printed)
    (relative L2); every leaf's update within MESH_OWN_REL of one card's
    AdamW on the sharded step's own gathered gradients; every rank's loss
    the same bits, and every MoE call's expert ids the same bits on the
    model ranks of a batch group. One card routes as the mesh did (its
    gates from its own probabilities at the mesh's experts); where one
    card's own router picks other experts for a token, that token must be
    a near-tie. The update against the unsharded step's
    is printed (AdamW's first step is lr·sign(g) where |g| ≫ eps: an entry
    whose gradient is below the bf16 noise may take the other sign). Then
    each planted fault of the step (``MESH_FAULTS``) of the kinds the spec
    names that reaches the step must fail the same check, at the same
    limits, on the figures its step gathers (the loss, the routing and
    every gradient leaf: a fault's step gathers no masters)."""
    c = res["check"]
    loss_rel = abs(c["loss"] - c["want_loss"]) / abs(c["want_loss"])

    def worst(key):
        return max(c[key].items(), key=lambda kv: kv[1])
    g, mst, u, own = (worst(k) for k in ("grad_rel", "master_rel",
                                          "update_rel", "own_rel"))
    split, calls = route_splits(c)
    rt, alone = c["routing"], c["alone"]
    if calls:
        ga = max(alone["grad_rel"].items(), key=lambda kv: kv[1])
        log(f"{tag}: {calls} MoE calls a rank, {split} of them routed "
            f"differently on a batch group's model ranks (limit 0); "
            f"{rt['moved']} of {rt['tokens']} tokens x calls routed to "
            f"other experts than one card's own routing, the worst across "
            f"a margin of {rt['worst_ulps']:.3g} bf16 ulps of one card's "
            f"logits, {rt['not_tie']} of them off a near-tie (over "
            f"{ROUTE_TIE_ULPS} ulps; limit 0); against one card routing "
            f"by its own router (printed): loss rel "
            f"{abs(alone['loss'] - alone['want_loss']) / abs(alone['want_loss']):.3g}, "
            f"worst gradient {ga[0]} {ga[1]:.3g}")
    log(f"{tag}: residual split over the sequence: {res['seq_split']}; "
        f"MoE split over its experts: {res['moe_split']}; "
        f"loss by rank {c['rank_losses']}; "
        f"sharded init against one card's draws: max |diff| "
        f"{c['same_draws']}; loss {c['loss']:.6f} against one card's "
        f"{c['want_loss']:.6f} (rel {loss_rel:.3g}, limit {MESH_LOSS_REL}); "
        f"of {len(c['grad_rel'])} leaves the worst gradient {g[0]} "
        f"{g[1]:.3g} (limit {MESH_GRAD_REL}), updated master {mst[0]} "
        f"{mst[1]:.3g} (limit {MESH_MASTER_REL}; masters drawn as zeros, "
        f"printed: {c['zero_init_master_rel']}), update against one "
        f"card's AdamW on the same gradients {own[0]} {own[1]:.3g} (limit "
        f"{MESH_OWN_REL}); update against the unsharded step's {u[0]} "
        f"{u[1]:.3g} (printed)")
    over = mesh_check_over(c)
    if over:
        fail(f"{tag}: over the limits: {over}")
    want = [n for n, (kind, _) in MESH_FAULTS.items()
            if kind in res["fault_kinds"] and n not in SERVE_PATH_FAULTS
            and fault_applies(kind, res)]
    if sorted(res["faults"]) != sorted(want):
        fail(f"{tag}: planted faults run {sorted(res['faults'])}, expected "
             f"{sorted(want)}")
    for name, fc in res["faults"].items():
        over = mesh_check_over(fc)
        if not over:
            fail(f"{tag}: the planted fault '{name}' passes the check")
            continue
        worst_over = max(over, key=lambda o: o[1] / max(o[2], 1e-30))
        loss_rel = abs(fc["loss"] - fc["want_loss"]) / abs(fc["want_loss"])
        g = max(fc["grad_rel"].items(), key=lambda kv: kv[1])
        spread = max(fc["rank_losses"]) - min(fc["rank_losses"])
        log(f"{tag}: planted fault '{name}' fails the check: {len(over)} "
            f"figures over their limits, the worst {worst_over[0]} "
            f"{worst_over[1]:.3g} (limit {worst_over[2]}); loss rel "
            f"{loss_rel:.3g} (limit {MESH_LOSS_REL}), loss spread over the "
            f"ranks {spread:.3g} (limit 0), worst gradient {g[0]} "
            f"{g[1]:.3g} (limit {MESH_GRAD_REL})")


def phase19_lm_mesh(seed: int) -> dict:
    """Phase 19: the LM on a (data 2, model 2) mesh of gloo ranks sharing
    card 0: at internlm2-1.8b's width with 2 layers, a sharded train step
    with four planted faults and greedy prefill + decode, each against the
    unsharded model on the same card; at deepseek-moe-16b's width with its
    first 2 layers (dense, then MoE, its experts split over the model
    axis), the sharded step with the two MoE faults. Returns the flash
    launches of internlm2's sharded step on one rank."""
    from repro_torch.launch.world import run_world
    common = {"mesh": MESH_LM_SHAPE, "check_layers": 2, "train_steps": 0,
              "seed": seed, "batch": MESH_LM_BATCH[0],
              "seq": MESH_LM_BATCH[1]}
    specs = [dict(common, arch=LM_ARCH, serve_layers=2,
                  prompt=MESH_LM_PROMPT, new=MESH_LM_NEW_GLOO,
                  faults=("any",)),
             dict(common, arch=MOE_MESH_ARCH, prompt=None, faults=("moe",))]
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_specs, MESH_LM_WORLD, backend="gloo",
                      device="cuda:0", args=(specs,), timeout_s=120.0,
                      join_timeout_s=MESH_LM_JOIN_S)
    log(f"[phase 19] gloo world of {MESH_LM_WORLD} on one card, mesh "
        f"{MESH_LM_SHAPE}: {time.perf_counter() - t0:.1f}s")
    r0, m0 = ranks[0]
    hold_mesh_check("[phase 19] 2 layers at internlm2's width", r0)
    hold_greedy("[phase 19] prefill + decode", r0["serve"]["got"],
                r0["serve"]["want"])
    if not m0["moe_split"]:
        fail("[phase 19] deepseek-moe-16b's experts are not split over the "
             "model axis")
    hold_mesh_check("[phase 19] 2 layers at deepseek-moe-16b's width", m0)
    launches = {r[0]["check_launches"] for r in ranks}
    want = 2 * 2           # a forward a layer and its remat recompute
    if launches != {want} or {r[1]["check_launches"] for r in ranks} \
            != {want}:
        fail(f"[phase 19] flash launches a sharded step {launches}, "
             f"expected {want} on every rank")
    log(f"[phase 19] flash launches: {want} a sharded step a rank, "
        f"{r0['serve_launches']} a greedy generate a rank; the generate "
        f"{r0['serve_s']:.3f}s, its collectives {r0['serve_collectives']}")
    return {"launches": want}


def phase20_lm_cards(n_cards: int, seed: int) -> dict:
    """Phase 20 (--cards 4): stablelm-12b on an NCCL world of one rank a
    card, mesh (data 2, model 2): the 2-layer check at full width, greedy
    prefill + decode of the full model sharded against one card, then
    TRAIN_STEPS steps at full width and depth."""
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    cfg = configs.get_config(MESH_TRAIN_ARCH)
    spec = {"arch": MESH_TRAIN_ARCH, "mesh": (2, n_cards // 2),
            "check_layers": 2, "serve_layers": None,
            "train_steps": TRAIN_STEPS, "seed": seed,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "prompt": MESH_LM_PROMPT, "new": MESH_LM_NEW,
            "faults": ("any", "seq")}
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_rank, n_cards, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0,
                      join_timeout_s=MESH_TRAIN_JOIN_S)
    log(f"[phase 20] NCCL world of {n_cards}, mesh {spec['mesh']}: "
        f"{time.perf_counter() - t0:.1f}s")
    r0 = ranks[0]
    hold_mesh_check(f"[phase 20] 2 layers at {cfg.name}'s width", r0)
    hold_greedy(f"[phase 20] {cfg.name} prefill + decode, "
                f"{MESH_LM_PROMPT[0]} x {MESH_LM_PROMPT[1]} + "
                f"{MESH_LM_NEW} tokens", r0["serve"]["got"],
                r0["serve"]["want"])
    log(f"[phase 20] {cfg.name}: sharded serving greedy generate "
        f"{r0['serve_s']:.3f}s with {r0['serve_launches']} flash launches")
    embed = cfg.vocab_size * cfg.d_model
    return hold_mesh_train(
        "[phase 20]", cfg, ranks, n_cards, cfg.param_count() - embed,
        "parameters less the embedding", MESH_BEFORE,
        "the residual whole over the sequence and the vocab gathered")


def hold_mesh_train(tag: str, cfg, ranks: list, n_cards: int,
                    active: int, counted: str, before=None,
                    before_what: str = "") -> dict:
    """The training steps of a mesh world (``lm_mesh_rank``'s train part):
    a finite, falling loss, the same bits on every rank, 2 flash launches
    a GQA layer a step a rank; the median step of steps 3-TRAIN_STEPS (the
    slowest rank's) beside its bound (6 x ``active`` parameters x the
    tokens plus the causal attention, at n_cards x 989 TFLOP/s),
    tokens/s, each card's peak memory and the collectives a step, printed
    beside ``before`` (a dict like MESH_BEFORE, or None)."""
    import math
    r0 = ranks[0]
    if r0["n_params"] != cfg.param_count():
        fail(f"{r0['n_params']} parameters, the config counts "
             f"{cfg.param_count()}")
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"H={cfg.n_heads}/{cfg.n_kv_heads}, hd={cfg.head_dim}, d_ff="
        f"{cfg.d_ff}, vocab={cfg.vocab_size}: {r0['n_params']} float32 "
        f"masters, {r0['local_bytes'] / 1e9:.3f} GB a card, drawn in "
        f"{r0['init_s']:.2f}s")
    for i, m in enumerate(r0["steps"]):
        c = m["collectives"]
        log(f"{tag} step {i + 1}: loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.6f} lr {m['lr']:.3e} {m['step_time_s']:.4f}s "
            f"flash launches {m['launches']}; allocator retries "
            f"{m['alloc_retries']}; collectives "
            + ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e9:.3f} GB"
                        for k, v in c.items() if v["count"]))
    losses = [m["loss"] for m in r0["steps"]]
    vals = losses + [m["grad_norm"] for m in r0["steps"]]
    if not all(map(math.isfinite, vals)):
        fail(f"{tag} a loss or grad norm is not finite: {vals}")
    if not losses[-1] < losses[0]:
        fail(f"{tag} step {len(losses)}'s loss {losses[-1]} is not below "
             f"step 1's {losses[0]}")
    for r in ranks[1:]:
        if [m["loss"] for m in r["steps"]] != losses:
            fail(f"{tag} rank {r['rank']} reports other losses")
    # the flash kernel runs each GQA attention in the forward and in its
    # remat recompute (MLA's absorbed attention is plain PyTorch)
    want = 2 * sum(seg.count for seg in cfg.segments
                   if seg.mixer in ("gqa", "hybrid"))
    launches = {m["launches"] for r in ranks for m in r["steps"]}
    if launches != {want}:
        fail(f"{tag} flash launches a step {sorted(launches)}, expected "
             f"{want} on every rank")
    b, s_len = r0["train_batch"]
    tokens = b * s_len
    step_s = max(r["step_s"] for r in ranks)
    pairs = visible_pairs(s_len, s_len, True, None)
    # QK^T and PV a visible pair and head: 2 (qk dims + v dims)
    per_pair = 2.0 * (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
                      + cfg.mla.v_dim) if cfg.mla is not None \
        else 4.0 * cfg.head_dim
    attn = 3 * per_pair * pairs * b * cfg.n_heads * cfg.n_layers
    flops = 6.0 * active * tokens + attn
    bound_s = flops / (n_cards * PEAK_BF16_OPS_PER_S)
    coll = r0["steps"][-1]["collectives"]
    coll_gb = sum(v["bytes"] for v in coll.values()) / 1e9
    peaks = [r["peak_gib"] for r in ranks]
    log(f"{tag} {len(losses)} steps of {b} x {s_len} = {tokens} tokens on "
        f"{n_cards} cards: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"median step of steps 3-{len(losses)} {step_s:.4f}s (slowest "
        f"rank's), {tokens / step_s:.0f} tokens/s; bound {bound_s:.4f}s (6 x "
        f"{active} {counted} x {tokens} tokens + causal attention "
        f"{attn:.3g} FLOP at {n_cards} x {PEAK_BF16_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s bf16), {bound_s / step_s:.1%} of it; peak device memory "
        f"by card {[round(p, 3) for p in peaks]} GiB (reserved "
        f"{[round(r['reserved_gib'], 3) for r in ranks]}); collectives a step "
        f"{coll_gb:.3f} GB of output a rank; flash launches a step {want}")
    now = {"step_s": step_s, "peak_gib": round(max(peaks), 3),
           "collectives": {k: (v["count"], round(v["bytes"] / 1e9, 3))
                           for k, v in coll.items() if v["count"]}}
    log(f"{tag} this tree's step as a constant: {json.dumps(now)}")
    if before is not None:
        log(f"{tag} against {before_what} (before): step {step_s:.4f}s "
            f"against {before['step_s'][0]}-{before['step_s'][1]}s; peak "
            f"{max(peaks):.2f} GiB a card against {before['peak_gib']} GiB; "
            "collectives a step "
            + ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e9:.3f} GB"
                        for k, v in coll.items() if v["count"])
            + " against "
            + ", ".join(f"{k} {n} x {gb} GB"
                        for k, (n, gb) in before["collectives"].items()))
    return {"launches": want, "step_s": step_s, "bound_s": bound_s,
            "peaks": peaks, "collective_gb": coll_gb}


def phase21_moe_cards(n_cards: int, seed: int) -> dict:
    """Phase 21 (--cards 4): deepseek-moe-16b on an NCCL world of one rank
    a card, mesh (data 2, model 2), its 64 routed experts split over the
    model axis (32 a card): the 2-layer check (layer 0 dense, layer 1 MoE)
    at full width with the two MoE faults, greedy prefill + decode of the
    full model sharded against one card routed as the mesh routed
    (``hold_serving``), then TRAIN_STEPS steps at full width and depth,
    beside MOE_BEFORE_WHY."""
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    cfg = configs.get_config(MOE_MESH_ARCH)
    spec = {"arch": MOE_MESH_ARCH, "mesh": (2, n_cards // 2),
            "check_layers": 2, "serve_layers": None,
            "train_steps": TRAIN_STEPS, "seed": seed,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "prompt": MESH_LM_PROMPT, "new": MESH_LM_NEW, "faults": ("moe",)}
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_rank, n_cards, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0,
                      join_timeout_s=MESH_TRAIN_JOIN_S)
    log(f"[phase 21] NCCL world of {n_cards}, mesh {spec['mesh']}: "
        f"{time.perf_counter() - t0:.1f}s")
    r0 = ranks[0]
    if not (r0["moe_split"] and r0["train_moe_split"]):
        fail(f"[phase 21] {cfg.name}'s experts are not split over the "
             f"model axis")
    hold_mesh_check(f"[phase 21] 2 layers at {cfg.name}'s width", r0)
    hold_serving("[phase 21]", cfg, r0)
    res = hold_mesh_train("[phase 21]", cfg, ranks, n_cards,
                          *active_parameters(cfg))
    log(f"[phase 21] against the experts gathered whole and run on every "
        f"model rank (before): {MOE_BEFORE_WHY}; here peak "
        f"{max(res['peaks']):.2f} GiB a card")
    return res


def active_parameters(cfg) -> tuple:
    """(the parameters a token uses, what they are): every weight but the
    embedding and the routed experts it is not sent to (top k of E in
    each MoE layer)."""
    mo = cfg.moe
    n_moe = sum(seg.count for seg in cfg.segments if seg.ffn == "moe")
    idle = n_moe * (mo.n_routed - mo.top_k) * 3 * cfg.d_model * mo.d_expert
    return (cfg.param_count() - cfg.vocab_size * cfg.d_model - idle,
            f"active parameters (all but the embedding and "
            f"{mo.n_routed - mo.top_k} of {mo.n_routed} routed experts a MoE "
            f"layer)")


def phase22_mla_cards(n_cards: int, seed: int) -> dict:
    """Phase 22 (--cards 4): deepseek-v2-lite-16b on an NCCL world of one
    rank a card, mesh (data 2, model 2), its MLA split over its 16 heads on
    the model axis (8 a card) and its 64 routed experts as phase 21's: the
    2-layer check (layer 0 MLA + dense MLP, layer 1 MLA + MoE) at full
    width with the two MLA faults, greedy serving of the full model held as
    phase 21's, then TRAIN_STEPS steps at full width and depth beside
    MLA_BEFORE (MLA gathered whole on every model rank). MLA's attention is
    plain PyTorch: 0 flash launches a rank."""
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    cfg = configs.get_config(MLA_MESH_ARCH)
    spec = {"arch": MLA_MESH_ARCH, "mesh": (2, n_cards // 2),
            "check_layers": 2, "serve_layers": None,
            "train_steps": TRAIN_STEPS, "seed": seed,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "prompt": MESH_LM_PROMPT, "new": MESH_LM_NEW, "faults": ("mla",)}
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_rank, n_cards, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0,
                      join_timeout_s=MESH_TRAIN_JOIN_S)
    log(f"[phase 22] NCCL world of {n_cards}, mesh {spec['mesh']}: "
        f"{time.perf_counter() - t0:.1f}s")
    r0 = ranks[0]
    if not (r0["mla_split"] and r0["train_mla_split"]):
        fail(f"[phase 22] {cfg.name}'s MLA is not split over the model axis")
    if not (r0["moe_split"] and r0["train_moe_split"]):
        fail(f"[phase 22] {cfg.name}'s experts are not split over the model "
             f"axis")
    launches = {r["check_launches"] for r in ranks}
    if launches != {0}:
        fail(f"[phase 22] flash launches a sharded step {sorted(launches)}, "
             f"expected 0 (MLA's attention is plain PyTorch)")
    hold_mesh_check(f"[phase 22] 2 layers at {cfg.name}'s width", r0)
    hold_serving("[phase 22]", cfg, r0)
    res = hold_mesh_train("[phase 22]", cfg, ranks, n_cards,
                          *active_parameters(cfg), MLA_BEFORE,
                          "MLA gathered whole on every model rank")
    return res


def phase23_serve_cards(n_cards: int, seed: int) -> dict:
    """Phase 23 (--cards 4): qwen3-32b served on an NCCL world of one rank
    a card, mesh (data 2, model 2): a prefill's residual split over the
    sequence (S = 4,096 ≥ 2,048, which the model axis divides), the
    embedding and the head on their vocab shard, the logits split over the
    vocab on ``model``. First the flash kernel at the prefill's local shape
    on card 0 against its plain version, beside SDPA and its bound; then
    the check (the first SERVE_CHECK_LAYERS layers at full width, greedy
    prefill + decode sharded against one card: logits, tokens, every
    rank's tokens, each cache layer), the three planted serving faults
    against the same check, and the full 64-layer model through
    ``Engine.generate`` (SERVE_GENERATE), printed beside the tree that
    served with the tables gathered whole and the residual whole
    (SERVE_BEFORE)."""
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    cfg = configs.get_config(SERVE_MESH_ARCH)
    m = n_cards // 2
    b_loc, s_len = SERVE_GENERATE[0] // 2, SERVE_GENERATE[1]
    flash = flash_at_shape("[phase 23] the prefill's local shape:", b_loc,
                           s_len, cfg.n_heads // m, cfg.n_kv_heads // m,
                           cfg.head_dim, gate=True)
    spec = {"arch": SERVE_MESH_ARCH, "mesh": (2, m), "check_layers": 0,
            "serve_layers": SERVE_CHECK_LAYERS, "train_steps": 0,
            "seed": seed, "batch": SERVE_GENERATE[0], "seq": s_len,
            "prompt": SERVE_CHECK_PROMPT, "new": SERVE_CHECK_NEW,
            "faults": (), "hold_caches": True,
            "serve_faults": tuple(n for n, (kind, _) in MESH_FAULTS.items()
                                  if kind == "serve"),
            "generate": SERVE_GENERATE}
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_rank, n_cards, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0,
                      join_timeout_s=MESH_TRAIN_JOIN_S)
    log(f"[phase 23] NCCL world of {n_cards}, mesh {spec['mesh']}: "
        f"{time.perf_counter() - t0:.1f}s")
    r0 = ranks[0]
    tag = (f"[phase 23] {cfg.name}, first {SERVE_CHECK_LAYERS} layers, "
           f"{SERVE_CHECK_PROMPT[0]} x {SERVE_CHECK_PROMPT[1]} + "
           f"{SERVE_CHECK_NEW} tokens")
    if not r0["serve_seq_split"]:
        fail(f"{tag}: the prefill's residual is not split over the sequence")
    over = serve_check_over(r0["serve"])
    hold_greedy(f"{tag} against one card", r0["serve"]["got"],
                r0["serve"]["want"])
    rel = cache_worst(r0["serve"])
    log(f"{tag}: every rank's tokens equal: {r0['serve']['ranks_agree']}; "
        f"caches after the last step against one card's, the worst layer "
        f"of each buffer (rel L2, layer): {rel} (limit {MESH_LOGIT_REL}); "
        f"{r0['serve_launches']} flash launches a rank; collectives "
        f"{r0['serve_collectives']}")
    if over:
        fail(f"{tag}: over the limits: {over}")
    want = sorted(n for n, (kind, _) in MESH_FAULTS.items()
                  if kind == "serve")
    if sorted(r0["serve_faults"]) != want:
        fail(f"[phase 23] planted serving faults run "
             f"{sorted(r0['serve_faults'])}, expected {want}")
    for name, res in r0["serve_faults"].items():
        held = dict(res, want=r0["serve"]["want"])
        f_over = serve_check_over(held)
        w = max(cache_worst(held).values())[0]
        log(f"[phase 23] planted fault '{name}': "
            f"{'fails' if f_over else 'PASSES'} the check: logits "
            f"{greedy_over(res['got'], r0['serve']['want'])['logit_rel']:.3g} "
            f"(limit {MESH_LOGIT_REL}), worst cache layer {w:.3g} (limit "
            f"{MESH_LOGIT_REL}); {len(f_over)} figures over their limits: "
            f"{f_over[:3]}")
        if not f_over:
            fail(f"[phase 23] the planted fault '{name}' passes the check")
    return hold_serve_generate("[phase 23]", cfg, ranks, n_cards, flash,
                               SERVE_BEFORE)


def phase24_attn_cards(n_cards: int, seed: int) -> dict:
    """Phase 24 (--cards 4): hymba-1.5b on an NCCL world of one rank a
    card, mesh ATTN_MESH (data 1, model 4), its attention split over the
    model axis where the axis divides neither its 25 heads nor its 5 KV
    heads (``sharding.head_ranges``: 10/5/5/5 query heads, 2/1/1/1 KV
    heads; the K/V cache held by each rank's own KV heads), its SSM split
    over its 50 SSD heads (``sharding.ssm_heads``: 13/13/12/12; the state
    and conv cache held by each rank's own heads), the two branches'
    partial outputs summed in one collective a layer. First the flash
    kernel at the ranks' local shapes on card 0, windowed and global,
    against its plain version beside SDPA and its bound; then the 2-layer
    check (layer 0 global, layer 1 windowed): a training step against one
    card with the "attn" and "ssm" faults of the step, and greedy prefill
    + decode against one card (logits, tokens, every cache layer whole,
    the K/V's decoded rows alone) with the two decode faults; then the
    full model through ``Engine.generate`` (ATTN_GENERATE) and TRAIN_STEPS
    training steps, each printed beside the tree that ran the SSM whole
    (SSM_BEFORE)."""
    from repro_torch import configs
    from repro_torch.launch.world import run_world
    from repro_torch.models import sharding as sh
    cfg = configs.get_config(ATTN_MESH_ARCH)
    d, m = ATTN_MESH
    heads = [sh.head_ranges(cfg.n_heads, cfg.n_kv_heads, m, i)
             for i in range(m)]
    most = max(qn for _, qn, _, _ in heads)
    log(f"[phase 24] {cfg.name}: {cfg.n_heads} query heads, "
        f"{cfg.n_kv_heads} KV heads, hd {cfg.head_dim} on (data {d}, model "
        f"{m}): (first query head, count, first KV head, count) by rank "
        f"{heads}; the largest rank runs {most} query heads against a mean "
        f"of {cfg.n_heads / m:.2f} ({most * m / cfg.n_heads:.2f}x)")
    ssm = sh.ssm_heads(cfg, argparse.Namespace(shape={"data": d,
                                                      "model": m}))
    nh = cfg.ssm.n_heads(cfg.d_model)
    log(f"[phase 24] {cfg.name}: {nh} SSD heads of hd {cfg.ssm.head_dim}, "
        f"d_state {cfg.ssm.d_state}: (first SSD head, count) by rank "
        f"{ssm}; the largest rank scans {max(n for _, n in ssm)} against a "
        f"mean of {nh / m:.2f}")
    gb, gp, _ = ATTN_GENERATE
    window = next(seg.window for seg in cfg.segments if seg.window)
    flash = {}
    for qn, kn in sorted({(h[1], h[3]) for h in heads}, reverse=True):
        for w in (window, None):
            flash[(qn, kn, w)] = flash_at_shape(
                f"[phase 24] a rank's local shape ({qn}/{kn} heads):",
                gb // d, gp, qn, kn, cfg.head_dim, window=w, gate=True)
    spec = {"arch": ATTN_MESH_ARCH, "mesh": ATTN_MESH, "check_layers": 2,
            "serve_layers": 2, "train_steps": TRAIN_STEPS, "seed": seed,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "prompt": ATTN_CHECK_PROMPT, "new": MESH_LM_NEW,
            "faults": ("attn", "ssm"), "serve_faults": SERVE_PATH_FAULTS,
            "hold_caches": True, "hold_decode_rows": True,
            "generate": ATTN_GENERATE}
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_rank, n_cards, backend="nccl", device="cuda",
                      args=(spec,), timeout_s=300.0,
                      join_timeout_s=MESH_TRAIN_JOIN_S)
    log(f"[phase 24] NCCL world of {n_cards}, mesh {spec['mesh']}: "
        f"{time.perf_counter() - t0:.1f}s")
    r0 = ranks[0]
    if not (r0["attn_split"] and r0["ssm_split"]):
        fail(f"[phase 24] {cfg.name}'s attention or SSM is not split over "
             f"the model axis (attention {r0['attn_split']}, SSM "
             f"{r0['ssm_split']})")
    launches = {r["check_launches"] for r in ranks}
    if launches != {2 * 2}:
        fail(f"[phase 24] flash launches a sharded 2-layer step "
             f"{sorted(launches)}, expected 4 on every rank (a forward a "
             f"layer and its remat recompute)")
    hold_mesh_check(f"[phase 24] 2 layers at {cfg.name}'s width", r0)
    tag = (f"[phase 24] {cfg.name}, first 2 layers, {ATTN_CHECK_PROMPT[0]} x "
           f"{ATTN_CHECK_PROMPT[1]} + {MESH_LM_NEW} tokens")
    over = serve_check_over(r0["serve"])
    hold_greedy(f"{tag} against one card", r0["serve"]["got"],
                r0["serve"]["want"])
    log(f"{tag}: every rank's tokens equal: {r0['serve']['ranks_agree']}; "
        f"caches after the last step against one card's, the worst layer "
        f"of each buffer (rel L2, layer): {cache_worst(r0['serve'])} (limit "
        f"{MESH_LOGIT_REL}); {r0['serve_launches']} flash launches a rank; "
        f"collectives {r0['serve_collectives']}")
    if over:
        fail(f"{tag}: over the limits: {over}")
    if sorted(r0["serve_faults"]) != sorted(SERVE_PATH_FAULTS):
        fail(f"[phase 24] planted serving faults run "
             f"{sorted(r0['serve_faults'])}, expected "
             f"{sorted(SERVE_PATH_FAULTS)}")
    for name, res in r0["serve_faults"].items():
        held = dict(res, want=r0["serve"]["want"])
        f_over = serve_check_over(held)
        log(f"[phase 24] planted fault '{name}': "
            f"{'fails' if f_over else 'PASSES'} the check: logits "
            f"{greedy_over(res['got'], r0['serve']['want'])['logit_rel']:.3g} "
            f"(limit {MESH_LOGIT_REL}), caches {cache_worst(held)} (limit "
            f"{MESH_LOGIT_REL}); {len(f_over)} figures over their limits: "
            f"{f_over[:3]}")
        if not f_over:
            fail(f"[phase 24] the planted fault '{name}' passes the check")
    what = "the SSM whole on every model rank"
    gen = hold_serve_generate("[phase 24]", cfg, ranks, n_cards,
                              flash[(most, heads[0][3], None)],
                              SSM_BEFORE["generate"], what,
                              gen=ATTN_GENERATE, mesh=ATTN_MESH)
    embed = cfg.vocab_size * cfg.d_model
    train = hold_mesh_train("[phase 24]", cfg, ranks, n_cards,
                            cfg.param_count() - embed,
                            "parameters less the embedding",
                            SSM_BEFORE["train"], what)
    for (qn, kn, w), f in flash.items():
        log(f"[phase 24] flash row at {gb // d} x {gp}, {qn}/{kn} heads, "
            f"window {w}: ms {f['ms']:.4f} bound_ms {f['bound_ms']:.4f} "
            f"plain_ms {f['plain_ms']:.4f} SDPA ms {f['library_ms']:.4f}; "
            f"launches a rank: {gen['launches']} a generate, "
            f"{train['launches']} a training step")
    return {"flash": flash, "generate": gen, "train": train}


def cache_worst(sv: dict) -> dict:
    """Each held cache buffer's worst (relative L2, layer) against one
    card's, over the batch rows whose greedy tokens never parted from one
    card's (a row that parts at a near-tie, ``greedy_over``, feeds other
    tokens after it, so its cache rows differ by construction); (inf, -1)
    where every row parted."""
    parted = {r for r, _, _ in greedy_over(sv["got"], sv["want"])["ties"]}
    out = {}
    for name, rel in sv["cache_rel"].items():
        held = [(rel[layer][row], layer) for layer in range(len(rel))
                for row in range(len(rel[layer])) if row not in parted]
        out[name] = max(held) if held else (float("inf"), -1)
    return out


def serve_check_over(sv: dict) -> list:
    """Phase 23's check over its limits (what, figure, limit): the greedy
    tokens and logits against one card's (``greedy_over``), each cache
    buffer's worst layer over MESH_LOGIT_REL relative L2 on the rows that
    never parted (``cache_worst``; every row parted counts as over), the
    ranks' tokens unequal."""
    over = list(greedy_over(sv["got"], sv["want"])["over"])
    over += [(f"cache {name} layer {layer}", rel, MESH_LOGIT_REL)
             for name, (rel, layer) in cache_worst(sv).items()
             if not rel <= MESH_LOGIT_REL]
    if not sv["ranks_agree"]:
        over.append(("ranks' tokens unequal", 1, 0))
    return over


def hold_serve_generate(tag: str, cfg, ranks: list, n_cards: int,
                        flash: dict, before=None,
                        before_what: str = "the tables gathered whole and "
                        "the residual whole", gen=None,
                        mesh=None) -> dict:
    """The full-depth ``Engine.generate`` of a mesh world
    (``lm_mesh_rank``'s generate part): finite tokens in the vocabulary,
    the same on every rank, one flash launch a layer a rank; prefill s,
    prompt tokens/s beside the bound of 2 x the parameters less the
    embedding x the prompt tokens plus the causal attention at n_cards x
    989 TFLOP/s; decode ms/step beside the weight-read bound (a rank reads
    the weights less the embedding over the model axis and its own K/V
    cache, ``kv_bytes``, at 3.35 TB/s); peak memory a card; the
    layer's residual at the prefill and at a decode step; each rank's
    collectives of the prefill and of one decode step by kind; printed
    beside ``before`` (a dict like SERVE_BEFORE, or None)."""
    import math
    gb, gp, gnew = gen or SERVE_GENERATE
    d, m = mesh or (2, n_cards // 2)
    g0 = ranks[0]["generate"]
    st = g0["stats"]
    embed = cfg.vocab_size * cfg.d_model
    body = cfg.param_count() - embed
    pairs = visible_pairs(gp, gp, True, None)
    attn = 4.0 * cfg.head_dim * pairs * gb * cfg.n_heads * cfg.n_layers
    prefill_bound = (2.0 * body * gb * gp + attn) / (
        n_cards * PEAK_BF16_OPS_PER_S)
    prefill_s = max(r["generate"]["stats"]["prefill_s"] for r in ranks)
    step_ms = max(r["generate"]["stats"]["decode_s"]
                  / r["generate"]["stats"]["decode_steps"]
                  for r in ranks) * 1e3
    # the busiest rank's K/V cache (its own KV heads where the attention
    # runs split, a channel share where it runs whole), half of it filled
    # past the prompt on average over the decode steps
    kv_cache = max(r["generate"]["kv_bytes"] for r in ranks)
    kv = kv_cache * (gp + gnew // 2) / (gp + gnew)
    read_bound_ms = (2.0 * body / m + kv) / PEAK_BYTES_PER_S * 1e3
    peaks = [round(r["generate"]["peak_gib"], 3) for r in ranks]

    def kinds(c):
        return ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e9:.4f} GB"
                         for k, v in c.items() if v["count"]) or "none"
    log(f"{tag} {cfg.name} full depth: {cfg.n_layers} layers, "
        f"d={cfg.d_model}, H={cfg.n_heads}/{cfg.n_kv_heads}, "
        f"hd={cfg.head_dim}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, "
        f"{g0['n_params']} bf16 parameters, {g0['local_bytes'] / 1e9:.3f} "
        f"GB a card, drawn in {g0['init_s']:.2f}s")
    log(f"{tag} Engine.generate of {gb} x {gp} prompt tokens + {gnew} new "
        f"on {n_cards} cards: prefill {prefill_s:.4f}s (slowest rank's), "
        f"{gb * gp / prefill_s:.0f} prompt tokens/s, bound "
        f"{prefill_bound:.4f}s (2 x {body} parameters less the embedding x "
        f"{gb * gp} tokens + causal attention {attn:.3g} FLOP at "
        f"{n_cards} x {PEAK_BF16_OPS_PER_S / 1e12:.0f} TFLOP/s), "
        f"{prefill_bound / prefill_s:.1%} of it; time to first token "
        f"{st['ttft_s']:.4f}s; decode {step_ms:.3f} ms/step over "
        f"{st['decode_steps']} steps (slowest rank's), weight-read bound "
        f"{read_bound_ms:.3f} ms ({2.0 * body / m / 1e9:.3f} GB of weights "
        f"and {kv / 1e9:.3f} GB of K/V a rank, of a {kv_cache / 1e9:.3f} GB "
        f"K/V cache, at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); peak device memory by card "
        f"{peaks} GiB; the first layer's residual {g0['prefill_carry']} at "
        f"the prefill, {g0['decode_carry']} at a decode step; flash "
        f"launches a generate a rank {g0['launches']}")
    for r in ranks:
        g = r["generate"]
        log(f"{tag} rank {r['rank']} {r['coord']}: prefill collectives "
            f"{kinds(g['prefill_collectives'])}; one decode step "
            f"{kinds(g['decode_collectives'])}")
    now = {"prefill_s": round(prefill_s, 4), "decode_ms": round(step_ms, 3),
           "peak_gib": max(peaks),
           "prefill": {k: (v["count"], round(v["bytes"] / 1e9, 4))
                       for k, v in g0["prefill_collectives"].items()},
           "decode": {k: (v["count"], round(v["bytes"] / 1e9, 4))
                      for k, v in g0["decode_collectives"].items()}}
    log(f"{tag} this tree's generate as a constant: {json.dumps(now)}")
    if before is not None:
        log(f"{tag} against {before_what} (before): prefill "
            f"{prefill_s:.4f}s against "
            f"{before['prefill_s'][0]}-{before['prefill_s'][1]}s; decode "
            f"{step_ms:.3f} against {before['decode_ms'][0]}-"
            f"{before['decode_ms'][1]} ms/step; peak {max(peaks):.3f} against "
            f"{before['peak_gib']} GiB a card; rank 0's prefill collectives "
            f"{now['prefill']} against {before['prefill']}; a decode step's "
            f"{now['decode']} against {before['decode']} ((count, GB))")
    if g0["n_params"] != cfg.param_count():
        fail(f"{tag} {g0['n_params']} parameters, the config counts "
             f"{cfg.param_count()}")
    for r in ranks:
        g = r["generate"]
        if not (g["ranks_agree"] and g["tokens_ok"]):
            fail(f"{tag} rank {r['rank']}: tokens unequal across the ranks "
                 f"or out of the vocabulary")
        if g["launches"] != sum(seg.count for seg in cfg.segments
                                if seg.mixer in ("gqa", "hybrid")):
            fail(f"{tag} rank {r['rank']} launched the flash kernel "
                 f"{g['launches']} times in one generate, expected "
                 f"{cfg.n_layers} (one a layer)")
    want = (gb // d, gp // m, cfg.d_model)
    if g0["prefill_carry"] != want:
        fail(f"{tag} the prefill's layers take {g0['prefill_carry']}, "
             f"expected {want} (the residual split over the sequence)")
    if not math.isfinite(prefill_s + step_ms):
        fail(f"{tag} timings not finite")
    return dict(now, flash=flash, launches=g0["launches"],
                prefill_bound_s=prefill_bound, read_bound_ms=read_bound_ms)


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (the folder is not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart_draws(n: int, grids: int, seed: int = 0):
    """One RB map fitted on the CPU and one start block from numpy, as a
    plan for quickstart's fit on either device: the same draws."""
    import numpy as np

    from repro_torch.core import ExecutionPlan, RBMap, SolverOptions
    from repro_torch.core.eigensolver import lobpcg_block_width
    from repro_torch.data.synthetic import make_rings

    x, _ = make_rings(n, 2, seed=0)
    fm = RBMap(n_grids=grids, sigma=0.15).fit(seed, x)
    b = lobpcg_block_width(n, 2, SolverOptions().buffer)
    x0 = np.random.default_rng(seed).standard_normal((n, b)).astype(
        np.float32)
    meta, state = fm.meta_dict(), fm.state_dict()
    return lambda device: ExecutionPlan(
        feature_map=RBMap.from_state(meta, state, device=device), eig_x0=x0)


def phase25_examples() -> dict:
    """The four examples through ``main(argv)`` on the card at the JAX
    package's defaults (EXAMPLE_RUNS), each holding the kernels it must
    launch (``ops.LAUNCHES`` set to 0 before it, read after); quickstart's
    labels against the CPU's on the same draws, its streamed labels against
    a device-resident fit of the same rows; the engine against
    ``model.predict`` bit for bit and the HTTP answer against the engine;
    embed_cluster's reloaded predict bit-identical; serve_lm's tokens in
    range and the same twice; embed_cluster and serve_lm on the card
    against the CPU (``lm_examples_against_cpu``); then quickstart once as
    a command line at its defaults. Returns {kernel: launches over the
    example runs}."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import SCRBConfig, executor, metrics
    from repro_torch.kernels import ops

    quiet = lambda *a: None
    total: dict = {}
    out = {}
    for tag, name, argv, kernels in EXAMPLE_RUNS:
        mod = load_example(name)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        missing = [k for k in kernels if counts[k] <= 0]
        log(f"[phase 25] {tag} ({' '.join(argv) or 'defaults'}): "
            f"{wall:.2f}s; launches {({k: v for k, v in counts.items() if v})}")
        if missing:
            fail(f"example {tag} launched no {missing} kernel")
        out[tag] = res
    qs = out["quickstart"]
    log(f"[phase 25] quickstart metrics {qs['metrics']}, D "
        f"{qs['diagnostics']['n_features_D']}, iterations "
        f"{qs['diagnostics']['solver_iterations']}; k-means baseline "
        f"{qs['kmeans_metrics']}")
    # the card against the CPU, the same draws
    mod = load_example("quickstart")
    plan = quickstart_draws(4_000, 256)
    t0 = time.perf_counter()
    cpu = mod.run(device="cpu", plan=plan("cpu"), log=quiet)
    card = mod.run(device="cuda", plan=plan("cuda"), log=quiet)
    ari = metrics.adjusted_rand_index(card["labels"], cpu["labels"])
    log(f"[phase 25] quickstart on the card against the CPU, the same RB "
        f"grids and start block: ARI {ari:.6f} ({time.perf_counter() - t0:.1f}"
        f"s, the CPU's fit {cpu['seconds']:.1f}s)")
    if ari < EXAMPLE_ARI:
        fail(f"quickstart's labels on the card against the CPU's: ARI "
             f"{ari:.4f} < {EXAMPLE_ARI}")
    big = out["quickstart covtype N"]
    log(f"[phase 25] quickstart at N={COVTYPE[3]}: metrics {big['metrics']}"
        f", stages {big['stages']}")
    # streamed against device-resident on the same 100,000 rows and grids
    streamed = out["quickstart streamed"]
    rows, chunk = EXAMPLE_STREAMED
    dev_plan = quickstart_draws(rows, 256)("cuda")
    chunked = dataclasses.replace(executor.plan_from_config(SCRBConfig(
        n_clusters=2, chunk_size=chunk)), feature_map=dev_plan.feature_map)
    s_run = mod.run(rows, 256, chunk, device="cuda", plan=chunked,
                    log=quiet)
    d_run = mod.run(rows, 256, device="cuda", plan=dev_plan, log=quiet)
    ari = metrics.adjusted_rand_index(s_run["labels"], d_run["labels"])
    log(f"[phase 25] quickstart streamed ({s_run['diagnostics']['n_chunks']}"
        f" chunks of {chunk}, ELL peak "
        f"{s_run['diagnostics']['ell_device_bytes_peak'] / 2**20:.1f} MiB) "
        f"against device-resident on the same {rows} rows and grids: ARI "
        f"{ari:.6f}; the example's own streamed run {streamed['metrics']}")
    if ari < EXAMPLE_ARI:
        fail(f"quickstart streamed against device-resident: ARI {ari:.4f} "
             f"< {EXAMPLE_ARI}")
    ec = out["embed_cluster"]
    log(f"[phase 25] embed_cluster: final LM loss {ec['losses'][-1]:.4f}, "
        f"sigma {ec['sigma']:.4f}, fit {ec['fit_metrics']}, served "
        f"{ec['served_metrics']} at {ec['docs_per_s']:.0f} docs/s, "
        f"reloaded predict bit-identical {ec['reloaded_identical']}")
    if ec["reloaded_identical"] is not True:
        fail("embed_cluster's reloaded model predicts other labels")
    sp = out["serve_predict"]
    st = sp["stats"]
    log(f"[phase 25] serve_predict: engine = model {sp['engine_equals_model']}"
        f", latency p50 {np.percentile(sp['latencies_ms'], 50):.3f} ms max "
        f"{max(sp['latencies_ms']):.3f} ms, {st['cells']} cells, "
        f"{st['rows_served']} rows in {st['batches']} batches, replayed "
        f"launches {st['replayed_launches']}; HTTP {sp['http']}")
    if not sp["engine_equals_model"] or sp["http"] != {
            "labels": sp["engine_predict_http_rows"].tolist()}:
        fail("serve_predict: the engine or its HTTP answer differs")
    if not st["replayed_launches"].get("kmeans_assign"):
        fail("serve_predict's engine replayed no kmeans_assign launch")
    for tag in ("serve_lm", "serve_lm internlm2"):
        lm = out[tag]
        argv = dict((r[0], r[2]) for r in EXAMPLE_RUNS)[tag]
        again = load_example("serve_lm").main(argv)
        toks, vocab = lm["tokens"], lm["vocab_size"]
        log(f"[phase 25] {tag} ({lm['model']}): {lm['tokens_per_s']:.1f} "
            f"tok/s, prefill {lm['stats'].get('prefill_s', 0):.4f}s; tokens "
            f"{toks.shape} in [{toks.min()}, {toks.max()}], the same twice "
            f"{np.array_equal(toks, again['tokens'])}")
        if toks.shape != (4, 32) or toks.min() < 0 or toks.max() >= vocab \
                or not np.array_equal(toks, again["tokens"]):
            fail(f"{tag}: tokens out of shape or range, or not the same "
                 "twice from one seed")
    lm_examples_against_cpu()
    # one example as a command line at its defaults (its __main__ and import
    # path on the card; every example's command line is tested on the CPU)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable,
                        str(ROOT / "examples_torch" / "quickstart.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=EXAMPLE_CLI_S)
    last = (r.stdout.strip().splitlines() or [""])[-1]
    log(f"[phase 25] python3 examples_torch/quickstart.py: exit "
        f"{r.returncode} in {time.perf_counter() - t0:.1f}s; last line: "
        f"{last[:160]}")
    if r.returncode != 0:
        fail(f"examples_torch/quickstart.py exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    return total


def lm_examples_against_cpu() -> dict:
    """embed_cluster (EXAMPLE_LM_STEPS steps of its pretraining) and
    serve_lm on the card against the same examples on the CPU, from the
    same weights (their ``params=``): each step's loss, the pooled
    embeddings of the card's trained weights (``embed_cluster.pool`` on
    each device) and the prefill's last-position logits on serve_lm's
    prompts, float32 throughout, so the flash kernel is held at the
    examples' own shapes (hd 32; S 31 in training, 32 pooled, 4/2 GQA
    heads at S 16 in the prefill). The card's side must launch the kernel;
    then it runs again under each of EXAMPLE_LM_FAULTS (the kernel's
    launch replaced by the plain version with the fault planted), each of
    which must fail the check. Returns the card's errors."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    quiet = lambda *a: None
    ec, sl = load_example("embed_cluster"), load_example("serve_lm")
    ecfg, scfg = ec.tiny_lm(ec.VOCAB), sl.tiny_lm()
    etree = T.params_to_reference(ecfg, T.init_params(
        ecfg, 0, device="cpu", masters=True))
    stree = T.params_to_reference(scfg, T.init_params(scfg, 0, device="cpu"))
    docs, _ = ec.topic_corpus(2_000, 32, ec.VOCAB, 6)

    def side(device: str) -> dict:
        """Both examples on ``device`` from the shared weights."""
        e = ec.run(device=device, steps=EXAMPLE_LM_STEPS, log=quiet,
                   params=T.params_from_reference(ecfg, etree, device=device,
                                                  masters=True))
        params = T.params_from_reference(scfg, stree, device=device)
        s = sl.run(device=device, params=params, log=quiet)
        b, p = s["prompts"].shape
        with torch.no_grad():
            logits, _ = T.prefill(
                scfg, params,
                {"tokens": torch.as_tensor(s["prompts"], device=device)},
                T.init_cache(scfg, b, p + 32, device=device))
        return {"losses": np.asarray(e["losses"], np.float64), "lm": e["lm"],
                "logits": logits.float().cpu().numpy()}

    def errors(card: dict) -> dict:
        weights = T.params_from_reference(
            ecfg, T.params_to_reference(ecfg, card["lm"]), device="cpu",
            masters=True)
        got = ec.pool(ecfg, card["lm"], docs, "cuda")
        want = ec.pool(ecfg, weights, docs, "cpu")
        return {"loss_rel": float(np.max(np.abs(card["losses"] - cpu["losses"])
                                         / np.abs(cpu["losses"]))),
                "pool_rel": float(np.abs(got - want).max()
                                  / np.abs(want).max()),
                "logits_abs": float(np.abs(card["logits"]
                                           - cpu["logits"]).max())}

    t0 = time.perf_counter()
    cpu = side("cpu")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card = side("cuda")
    err = errors(card)
    flash = ops.launch_counts()["flash_attention"]
    log(f"[phase 25] embed_cluster ({EXAMPLE_LM_STEPS} steps) and serve_lm's "
        f"prefill on the card against the CPU, the same weights: {err} "
        f"(limits {EXAMPLE_LM_TOL}), the flash kernel launched {flash} "
        f"times ({time.perf_counter() - t0:.1f}s)")
    if not flash:
        fail("the LM examples' card side launched no flash kernel")
    over = [k for k, v in err.items() if not v <= EXAMPLE_LM_TOL[k]]
    if over:
        fail(f"the LM examples on the card against the CPU: {over} over "
             f"the limit, {err}")
    faults = planted_faults()
    for name, must in EXAMPLE_LM_FAULTS.items():
        fault = faults[name]
        with _patched(ops, "_flash_launch",
                      lambda q, k, v, causal, window: fault(q, k, v)):
            got = errors(side("cuda"))
        caught = [k for k in must if not got[k] <= EXAMPLE_LM_TOL[k]]
        log(f"[phase 25] planted flash fault '{name}': {got}; over the "
            f"limit {caught}")
        if caught != list(must):
            fail(f"planted flash fault '{name}' passed the LM examples' "
                 f"check on {[k for k in must if k not in caught]}")
    return err


CELL_FAKE = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.distributed import lower_clustering_cell
from repro_torch.launch import mesh as M
world, cell = json.loads(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
mesh = M.make_mesh((world,), ("data",), device_type="cpu")
print("RECORD " + json.dumps({str(c): lower_clustering_cell(
    mesh, dim=0, compress=c, **cell) for c in (False, True)}))
"""


def fake_cell_records(world: int) -> dict:
    """``lower_clustering_cell`` of CELL on a fake world of ``world`` ranks
    on (data ``world``), in a process of its own (its fake group must not
    meet this run's NCCL groups): {"False" | "True": record}."""
    import os
    r = subprocess.run([sys.executable, "-c", CELL_FAKE,
                        json.dumps([world, CELL])],
                       env=dict(os.environ, PYTHONPATH=str(SRC)),
                       capture_output=True, text=True, timeout=300)
    line = [s for s in r.stdout.splitlines() if s.startswith("RECORD ")]
    if r.returncode != 0 or not line:
        fail(f"lower_clustering_cell on a fake world of {world} failed: "
             f"{r.stderr[-2000:]}")
    return json.loads(line[-1][len("RECORD "):])


def event_times(fn, iters: int, warmup: int = 2) -> list:
    """Device ms of each of ``iters`` calls of ``fn``, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def cell_rank(seed: int) -> dict:
    """One rank of phase 26's NCCL world: its data shard of CELL (idx
    uniform in each grid's bins, drawn from ``seed`` and the rank; row
    scales from the mesh's degree pass), one ``make_gram_matvec``
    iteration in float32 and compressed, each with its collectives and
    launches counted and held against the plain versions summed over the
    ranks; the planted fault (q without the all-reduce); times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as lm
    from repro_torch.models import sharding as sh

    require_built()
    mesh = lm.make_host_mesh()
    rank, world = lm.data_rank(mesh), dist.get_world_size()
    group = lm.data_group(mesh)
    n, r, d_g, k = CELL["n"], CELL["n_grids"], CELL["d_g"], CELL["k"]
    rows, d = n // world, r * d_g
    g = torch.Generator(device="cuda").manual_seed(seed * 1_000 + rank)
    idx = (torch.randint(0, d_g, (rows, r), generator=g, device="cuda",
                         dtype=torch.int32)
           + torch.arange(r, device="cuda", dtype=torch.int32) * d_g
           ).contiguous()
    deg, _ = D.make_degree_pass(mesh, idx, d, d_g)()
    s = (1.0 / torch.sqrt(r * deg)).contiguous()
    u = torch.randn((rows, k), generator=g, device="cuda")
    cscs = [ops.ell_csc(idx, d)]
    out = {"rank": rank, "card": torch.cuda.current_device(), "modes": {}}
    # the plain versions, summed over the ranks by a plain all-reduce
    q_plain = ref.zt_matmul_ref(idx, u, s, d)
    q_abs = ref.zt_matmul_ref(idx, u.abs(), s.abs(), d)
    dist.all_reduce(q_plain, group=group)
    dist.all_reduce(q_abs, group=group)
    want = ref.z_matmul_ref(idx, q_plain, s)
    terms = ref.z_matmul_ref(idx, q_abs, s.abs())

    def held(y, compress):
        if compress:
            err = float((y - want).norm() / want.norm())
            return err <= CELL_BF16_REL, err
        return within_sum_tolerance(y, want, terms)

    for compress in (False, True):
        gram = D.make_gram_matvec(mesh, idx, s, d, d_g, compress=compress,
                                  cscs=cscs)
        torch.cuda.synchronize()
        sh.reset_collectives()
        ops.reset_launch_counts()
        y = gram(u)
        torch.cuda.synchronize()
        mode = {"collectives": sh.collective_counts(),
                "launches": {kk: v for kk, v in ops.launch_counts().items()
                             if v}}
        mode["ok"], mode["err"] = held(y, compress)
        mode["ms"] = event_times(lambda: gram(u), CELL_ITERS)
        q = torch.randn((d, k), generator=g, device="cuda")
        mode["all_reduce_ms"] = event_times(
            lambda: D.all_reduce_sum(q.clone(), group, compress=compress),
            CELL_ITERS)
        with _patched(D, "all_reduce_sum",
                      lambda t, group, compress=False: t):
            mode["fault_ok"], mode["fault_err"] = held(gram(u), compress)
        out["modes"][str(compress)] = mode
    q = ops.zt_matmul(idx, u, s, d, d_g=d_g, csc=cscs[0])
    out["zt_ms"] = event_times(
        lambda: ops.zt_matmul(idx, u, s, d, d_g=d_g, csc=cscs[0]),
        CELL_ITERS)
    out["z_ms"] = event_times(lambda: ops.z_matmul(idx, q, s, d_g=d_g),
                              CELL_ITERS)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase26_cell_cards(n_cards: int, seed: int) -> dict:
    """One eigensolver iteration of the clustering cell (CELL) on an NCCL
    world of one rank a card, mesh (data ``n_cards``): the collectives
    counted on the cards against ``lower_clustering_cell``'s on a fake
    world of the same mesh and n; every rank's y within the sum tolerance
    of the plain zt then z summed over the ranks (compressed: within
    CELL_BF16_REL relative); the planted fault (q without the all-reduce)
    must fail that check; the iteration's median device ms in float32 and
    compressed, beside the zt and z products' bounds and the all-reduce's
    ring bound over NVLink."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.world import run_world

    records = fake_cell_records(n_cards)
    t0 = time.perf_counter()
    ranks = run_world(cell_rank, n_cards, backend="nccl", device="cuda",
                      args=(seed,), timeout_s=60.0,
                      join_timeout_s=CARDS_JOIN_S)
    log(f"[phase 26] NCCL world of {n_cards} (cards "
        f"{[rk['card'] for rk in ranks]}): {time.perf_counter() - t0:.1f}s, "
        "spawn included")
    if [rk["card"] for rk in ranks] != list(range(n_cards)):
        fail(f"phase 26's world of {n_cards} is not one rank a card")
    n, r, d_g, k = CELL["n"], CELL["n_grids"], CELL["d_g"], CELL["k"]
    rows, d = n // n_cards, r * d_g
    zt_b, zt_by = bound(*ops.zt_matmul_cost(rows, r, d, k))
    z_b, z_by = bound(*ops.z_matmul_cost(rows, r, d, k))
    med = lambda v: float(np.median(v))
    r0 = ranks[0]
    log(f"[phase 26] {rows} rows a card (n {n}), R {r}, d_g {d_g}, D {d}, "
        f"K {k}: zt_matmul {med(r0['zt_ms']):.4f} ms (bound {zt_b:.4f}, "
        f"{zt_by}), z_matmul {med(r0['z_ms']):.4f} ms (bound {z_b:.4f}, "
        f"{z_by}); peak {r0['peak_gib']:.2f} GiB a card")
    for compress in (False, True):
        rec = records[str(compress)]
        tag = "bf16" if compress else "fp32"
        for rk in ranks:
            mode = rk["modes"][str(compress)]
            if mode["collectives"] != rec["collectives"]:
                fail(f"phase 26 {tag}, rank {rk['rank']}: collectives "
                     f"{mode['collectives']} differ from the fake world's "
                     f"record {rec['collectives']}")
            if not mode["ok"]:
                fail(f"phase 26 {tag}, rank {rk['rank']}: y differs from the "
                     f"plain zt then z summed over the ranks (error "
                     f"{mode['err']:.3g})")
            if mode["fault_ok"]:
                fail(f"phase 26 {tag}, rank {rk['rank']}: the planted fault "
                     "(q without the all-reduce) passed the check")
            for kern in ("zt_matmul", "z_matmul"):
                if mode["launches"].get(kern) != 1:
                    fail(f"phase 26 {tag}: {mode['launches']} launches, not "
                         f"one {kern}")
        m0 = r0["modes"][str(compress)]
        payload = d * k * (2 if compress else 4)
        ring = 2 * (n_cards - 1) / n_cards * payload / NVLINK_BYTES_PER_S \
            * 1e3
        ar = m0["collectives"]["all-reduce"]
        errs = [float(f"{rk['modes'][str(compress)]['err']:.3g}")
                for rk in ranks]
        fault = [float(f"{rk['modes'][str(compress)]['fault_err']:.3g}")
                 for rk in ranks]
        log(f"[phase 26] {tag}: iteration {med(m0['ms']):.4f} ms median of "
            f"{CELL_ITERS} (min {min(m0['ms']):.4f}, max {max(m0['ms']):.4f})"
            f"; all-reduce of {payload} bytes {med(m0['all_reduce_ms']):.4f} "
            f"ms (ring bound over NVLink {ring:.4f}); collectives "
            f"{ar['count']} all-reduce of {ar['bytes']} bytes = the fake "
            f"world's record; errors {errs}; the planted fault fails on "
            f"every rank (errors {fault}); launches {m0['launches']}")
        log(f"[phase 26] {tag} record: argument bytes "
            f"{rec['memory']['argument_bytes']} a rank, temp "
            f"{rec['memory']['temp_bytes']}, flops {rec['cost']['flops']:.4g},"
            f" bytes accessed {rec['cost']['bytes_accessed']:.4g}")
    return {"ranks": ranks, "records": records}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the LM weights, prompts and samples")
    parser.add_argument("--kmeans-baseline", type=Path, default=None,
                        help="a kmeans_assign.cu of another tree, timed "
                             "beside this tree's kernel in phase 2")
    parser.add_argument("--cards", type=int, default=None, choices=(2, 4),
                        help="run phases 0, 1 and 15 (and 20-24 and 26 on 4: "
                             "more than one card) on this many cards instead "
                             "of phases 0-14, 16-19 and 25")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    card = phase0_card()
    if args.cards is not None:
        if card["device"]["count"] < args.cards:
            fail(f"--cards {args.cards} needs {args.cards} cards; "
                 f"{card['device']['count']} present")
        t0 = time.perf_counter()
        phase1_build()
        log(f"[phase 1] {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase15_cards(args.cards)
        log(f"[phase 15] {time.perf_counter() - t0:.1f}s")
        if args.cards == 4:
            t0 = time.perf_counter()
            phase20_lm_cards(args.cards, args.seed)
            log(f"[phase 20] {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            phase21_moe_cards(args.cards, args.seed)
            log(f"[phase 21] {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            phase22_mla_cards(args.cards, args.seed)
            log(f"[phase 22] {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            phase23_serve_cards(args.cards, args.seed)
            log(f"[phase 23] {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            phase24_attn_cards(args.cards, args.seed)
            log(f"[phase 24] {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            phase26_cell_cards(args.cards, args.seed)
            log(f"[phase 26] {time.perf_counter() - t0:.1f}s")
        log(f"[total] {time.perf_counter() - t_start:.1f}s")
        print(card["smi"])
        print(json.dumps({"ok": True, "device": card["device"]}), flush=True)
        return

    import torch

    from repro_torch.core import RBMap, SCRBConfig
    from repro_torch.core.rb import suggest_sigma
    from repro_torch.data.synthetic import SuiteSpec, generate

    t0 = time.perf_counter()
    phase1_build()
    log(f"[phase 1] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    x_np, y_np = generate(SuiteSpec(*COVTYPE), scale=1.0, seed=0)
    sigma = suggest_sigma(x_np)
    cfg = SCRBConfig(n_clusters=COVTYPE[1], n_grids=N_GRIDS, sigma=sigma)
    log(f"[data] covtype-shaped synthetic N={x_np.shape[0]} d={x_np.shape[1]}"
        f" K={COVTYPE[1]}, sigma={sigma:.6g}, made in "
        f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    x_dev = torch.as_tensor(x_np, device="cuda")
    fm = RBMap(n_grids=N_GRIDS, sigma=sigma).fit(cfg.seed, x_dev)
    kernels = phase2_kernels(x_dev, fm, baseline_src=args.kmeans_baseline)
    del x_dev
    torch.cuda.empty_cache()
    log(f"[phase 2] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    model, counts = phase3_fit(x_np, y_np, cfg)
    log(f"[phase 3] {time.perf_counter() - t0:.1f}s")
    for row in kernels:
        row["launches"] = counts[row["name"]]

    t0 = time.perf_counter()
    phase4_serve(model, x_np)
    log(f"[phase 4] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    phase5_determinism(x_np, cfg)
    log(f"[phase 5] {time.perf_counter() - t0:.1f}s")
    res = model.fit_result
    device_fit = {"labels": res.labels, "embedding": res.embedding,
                  "singular_values": res.singular_values,
                  "iterations": res.diagnostics["solver_iterations"],
                  "inertia": res.diagnostics["kmeans_inertia"]}
    model.fit_result = None        # the O(D·K) model stays for phase 12
    del res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flash = phase6_flash(args.seed)
    torch.cuda.empty_cache()
    log(f"[phase 6] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    flash["launches"] = phase7_lm(args.seed)
    kernels.append(flash)
    log(f"[phase 7] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    stream_counts = phase8_streaming(x_np, y_np, cfg, device_fit)
    for row in kernels:
        if row["name"] in ("bin_counts", "z_matmul_gather"):
            row["launches"] = stream_counts[row["name"]]   # streaming path's
    log(f"[phase 8] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    solver_fits = phase9_solvers(x_np, cfg, device_fit)["fits"]
    torch.cuda.empty_cache()
    log(f"[phase 9] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    comp = phase10_compressive()
    for row in kernels:        # launches per device compressive fit
        row["launches_compressive"] = comp["device"]["launches"][row["name"]]
    log(f"[phase 10] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base = phase11_baselines(x_np, y_np, sigma)
    log(f"[phase 11] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = phase12_engine({"rb": model, "sc_nys": base["nys_model"]}, x_np)
    for row in kernels:
        row["launches_engine"] = engine["replayed"].get(row["name"], 0)
    for row in kernels:
        for (bucket, k), b in row.pop("buckets", {}).items():
            log(f"[phase 12] z_matmul_gather bucket {bucket} x K {k}: "
                f"{b['ms'] * 1e3:.2f} µs device, bound "
                f"{b['bound_ms'] * 1e3:.3f} µs ({b['bound_by']}), "
                f"embedding_bag {b['library_ms'] * 1e3:.2f} µs, "
                f"{engine['rb_replays'][bucket]} launches by phase 12's "
                f"replays; the replay {engine['breakdown'][bucket]}")
    named = {row["name"] for row in kernels}
    unlisted = [k for k, v in engine["replayed"].items()
                if v and k not in named]
    if unlisted:
        fail(f"the engine replayed {unlisted}, which no kernels row holds")
    log(f"[phase 12] {time.perf_counter() - t0:.1f}s")
    del engine, base
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    part = phase13_partitioned(x_np, y_np, cfg, device_fit)
    for row in kernels:          # launches per partitioned covtype fit
        row["launches_partitioned"] = part["launches"][row["name"]]
    del part
    torch.cuda.empty_cache()
    log(f"[phase 13] {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    mesh = phase14_mesh(x_np, cfg, device_fit, model.feature_map,
                        solver_fits)
    del solver_fits
    for row in kernels:          # launches per mesh fit, on one rank
        row["launches_mesh"] = mesh["launches"][row["name"]]
    log(f"[phase 14] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    deepseek = phase16_deepseek(args.seed)
    for row in kernels:          # launches per generate
        row["launches_v2_lite"] = deepseek[DS_ARCHS[0]].get(row["name"], 0)
        row["launches_moe_16b"] = deepseek[DS_ARCHS[1]].get(row["name"], 0)
    log(f"[phase 16] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    new = phase17_new_models(args.seed)
    for row in kernels:          # launches per generate
        for arch, key in NEW_ARCHS.items():
            row[key] = new[arch].get(row["name"], 0)
    log(f"[phase 17] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train = phase18_train(args.seed)
    for row in kernels:          # launches per training step
        row["launches_train"] = train["full"]["launches"] \
            if row["name"] == "flash_attention" else 0
    log(f"[phase 18] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm_mesh = phase19_lm_mesh(args.seed)
    for row in kernels:          # launches per sharded step, on one rank
        row["launches_lm_mesh"] = lm_mesh["launches"] \
            if row["name"] == "flash_attention" else 0
    log(f"[phase 19] {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    examples = phase25_examples()
    for row in kernels:          # launches over the examples' runs
        row["launches_examples"] = examples.get(row["name"], 0)
    log(f"[phase 25] {time.perf_counter() - t0:.1f}s")

    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_compressive", "launches_engine",
            "launches_partitioned", "launches_mesh", "launches_v2_lite",
            "launches_moe_16b", *NEW_ARCHS.values(), "launches_train",
            "launches_lm_mesh", "launches_examples", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in kernels]}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": card["device"]}), flush=True)


if __name__ == "__main__":
    main()
