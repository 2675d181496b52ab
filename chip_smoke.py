#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--seed S] [--out DIR]
    python3 chip_smoke.py --only parallel     # the build and phase 14

Phases (any failure exits non-zero and prints no result line):

1. build    — every kernel source in ``src/repro_torch/csrc`` (K1, K2
              cosine top-k; K3 decode attention; K4 prefill attention and
              its backward; K5 WKV6), one nvcc per source, started
              together; ptxas register and spill lines logged, and for
              the attention backward's two bf16 kernels (TMA and wgmma,
              each instance) their registers, shared memory and spills,
              which must be none, and for its f32 tiled pair (each
              instance) registers and spills, which must be none, and the
              tensor-core instructions (HMMA, HGMMA) of its SASS, which
              must be none too;
2. kernels  — K1 (f32) and K2 (int8) against their plain PyTorch versions
              at serving shapes (D=768, N=65,536 rows, B in {0, 1, 4, 5, 8,
              32, 33}, k in {1, 16}, early exit on/off, a valid mask with
              holes), then timed beside the plain version and one library
              call (torch.topk over a masked q @ c.T, a yardstick only),
              with a torch.profiler split into pass 1 and pass 2 (K1 at
              every timed batch, K2 at B=4), which must show the kernel's
              own two launches and no other;
              K4 against its plain version over every mask mode (causal,
              bidirectional, window, prefix, ragged kv with a q offset,
              right-aligned queries) in f32 and bf16, bf16 at shapes
              ragged against its 128-row and 128-key tiles, with a kv ring
              that wraps four times and with qwen3's 40/8 heads, and K3
              with f32, bf16 and int8 caches; both at zamba2's head dim
              112 (32 heads, MHA; K4 and K3 pad it to 128, K3's bf16
              calls on its fast kernel) and at the main path's shapes too, then timed there (K4's TFLOP/s and share of its
              bound logged; both K4 calls, the bf16 prefill and the
              embedder's f32 one, and SDPA beside each also on the device
              through torch.profiler, K3 too: each call must show its
              one kernel and no other) beside the
              plain version, a bound and
              scaled_dot_product_attention (a yardstick only, never called
              by the port); bf16 outputs are held to 2^-7 |plain| + c x
              the rms of the output row (kernels.bf16_excess), and a kv
              tile dropped from the plain version must fail that limit;
3. cache    — one interleaved lookup / insert_spill stream with a shadow
              refresh commit, through the dense, pallas (K1) and pallas_q8
              (K2 + exact rescore) backends: identical decisions, and q8
              sims equal to dense sims bit for bit (DESIGN.md §15), both
              for lookups that K2 + the rescore decide and for those that
              fall back to the dense reference (at least 10 of 24 must be
              the former); the q8 margin-window sizes are logged;
4. serve    — the serve_with_siso stream (40 requests, batches of 4,
              max_new=8) through the ServingGateway: siso-embedder at its
              published widths in fp32, qwen3-14b at full width in bf16
              with seeded random weights, 20 of its 40 layers
              (``--layers``; SERVED_LAYERS),
              SISO bootstrapped from a synthetic history into a centroid
              region of >= 32,768 rows. Once with backend "pallas" (K1),
              once with "pallas_q8" (K2); each kernel's launch counter is
              zeroed just before its run and read just after. Every
              distinct kernel call of these runs (B, N, k, early exit,
              theta) is then held against the plain version at its own
              arguments. K4 runs in the embedder and the engine's prefill,
              K3 in every decode step; their launch counters are zeroed
              and read around each stream too, and every distinct K3/K4
              call (shapes, dtypes, masks, kv lengths) is held against the
              plain version at its own arguments. E.encode's host ms per
              batch (median over the stream) is logged. Before the stream, the
              engine check (reduced qwen3, fp32: cached decode equals
              re-prefill greedy decoding; with the int8 KV cache, batched
              decode equals one-sequence decode) runs on the card;
5. engine-long — qwen3-14b at full width and the served depth, the served run's
              weights, ModelEngine(n_slots=4, max_len=8192): four 4,096-token
              prompts through prefill (K4 on every layer), then 16 decode
              steps (K3 on every layer), once with the bf16 KV cache and
              once with the int8 one. The first prefill's last-position
              logits and the first decode step's logits are held against
              the plain layers on the same inputs; a planted fault in the
              prefill attention must exceed the limit. Every K3/K4 call
              of the prefills and steps is re-checked at its own
              arguments. Two more decode steps run under torch.profiler:
              the device's busy time per step, K3's share of it and the
              idle share; then one
              more prefill: its device busy time and K4's share of it.
6. slo      — the paper's comparison at the embedder's width (dim 768):
              (a) benchmarks/fig9_slo.py's configuration through the
              ServingSimulator over the analytic engine (qwen3-14b on one
              H100, concurrency 4): 8,000 training queries, then two test
              streams of 800 (rps 10 cv 0.1, rps 8 cv 5), capacity 512,
              for vLLM, GPTCache, SISO-NoDTA and SISO on backend pallas
              (K1), then SISO on dense and on pallas_q8 (K2 + exact
              rescore), which must give equal SimResults; (b)
              benchmarks/bench_slo.py's live harness (virtual clock, 2
              slots, 6 new tokens, 0.05 s ticks) over the served qwen3-14b
              weights, repeat_heavy and topic_drift, for SISO (built with
              ServingGateway.from_config, backend pallas), VectorCache and
              NoCache: every request completes, SISO serves from both the
              cache and the engine, and every distinct K1/K3/K4 call is
              re-checked at its own arguments with the earlier phases'.
              Hit ratio, SLO attainment, theta range and wall seconds are
              logged per system, not asserted.
7. planes   — persistence, the device -> host -> disk tiers and tenant
              namespaces at dim 768, after slo, on the served weights:
              (a) a child process (this script with ``--planes-child``)
              builds SISO on ``pallas`` with a device tier of 8,320 rows,
              a host tier of 512 (below the host HNSW's 4,096-row
              switch-over), a disk tier and four tenants, serves a seeded
              multi-tenant stream, saves through the port's
              CheckpointManager, and SIGKILLs itself; this process runs
              the same thing uninterrupted, restores the survivor,
              warm-starts, and requires equal tier membership, tier
              stats, tenant state, counters and clock, then serves a
              phase B in lockstep; the child's plain pallas_q8 SISO is
              restored too: its codes and scales must equal the dead
              mirror's, and its phase B must decide as dense with
              bit-equal sims; (b) bench_restart's drill over the served
              qwen3-14b with slo (b)'s virtual clock: phase A with
              persistence attached (at least one refresh commit), a
              drained full snapshot and a delta, phase B uninterrupted
              and on a fresh gateway warm-started from a copy of the
              directory ("full+delta"): equal hit masks, counters, theta
              trace and generation; a cold gateway for contrast; (c)
              bench_tiered's and bench_tenancy's drills at their smoke
              sizes, noise scaled by sqrt(32/768): the tier lift and the
              steady tenant's degradation, logged, not asserted. Every
              K1/K2/K3/K4 call (the child's too) is counted and re-checked
              at its own arguments with the other phases'.
8. replicas — the replica plane, its transports and the HTTP front end,
              after planes, on the served weights: (a) two Replicas in a
              ReplicaGroup (sync_every=1), each a
              ServingGateway.from_config over its own ModelEngine
              (the served qwen3-14b, bf16) on backend pallas at dim 768,
              the served embedder on every request, behind the port's
              CacheHTTPServer driven by urllib: 16 requests (a fresh
              query from user 0, its repeat from user 1 on the other
              replica, then anonymous traffic); every response 200 with
              X-Cache, X-Cache-Region and X-Replica, each fresh query a
              MISS, each repeat a spill HIT on the peer, /healthz with both
              replicas' replication stats, 503 + Retry-After after the
              drain; the same stream with sync_every=0 misses on every
              repeat; then on pallas_q8, where rows r0 re-answers are
              patched on r1 by update_spill_row and must decide as a dense
              replica fed the same record, sims bit-equal; (b)
              bench_replica's kill and rejoin (smoke sizes, dim 768): a
              child (``--replicas-child``) serves phase 1 with B
              snapshotting and is SIGKILLed by spawn_and_kill; phase 1 is
              replayed here and a fresh replica rejoins (warm_start, then
              add(reconcile=True)): its lookups equal the donor's
              element-wise; (c) the same over SocketTransport (B in a
              child, its successor reconciles through fetch_state) and
              R=3 under delays, drops and a healed partition: identical
              lookup content after two settle rounds; (b)/(c)'s engines
              are qwen3-14b at full width cut to 2 layers; (d) ``python -m
              repro_torch.launch.serve --mode replica --transport socket
              --replicas 2`` at its defaults: a MISS, then the peer's HIT
              once the delta crossed, transport stats in /healthz, SIGTERM
              ends all three processes with exit 0. Every kernel call (the
              children's through the files they leave, the launcher's
              replayed here) is re-checked at its own arguments.
9. shard    — the sharded cache plane (DESIGN.md §11) on S virtual shards
              of the card (``make_cache_mesh(S, devices=[cuda:0] * S)``),
              after replicas, on the served weights: (a) the served SISO
              (dim 768, 36,114 centroid rows) restored onto S = 1, 2, 4, 8
              on dense, pallas (K1's shard-local mode, K1-local) and
              pallas_q8 (K2 per shard + the exact rescore), with room for
              48 spill rows beyond its centroids: 324 queries in
              batches of 4 and 32 (the served stream's embeddings, exact
              repeats of centroid and spill rows, fresh misses recorded as
              spill rows, evicting LRU victims) with one refresh committed
              mid-stream, ticked a unit at a time: every LookupResult
              field, the generations
              through the refresh, LRU victims, spill clocks and counters
              equal one device's exact top-1 (dense; sims within ATOL;
              pallas_q8 bit for bit), the pallas shard counts equal each
              other bit for bit, row writes and no rebuild; (b) the served
              stream from the SISO's pre-stream state through
              ServingGateway.from_config with sharding over 4 shards and
              the served qwen3-14b engine: served-by per request as one
              device's pallas gateway, answers and answer ids as one
              device's dense gateway; cache_shards, rows and bytes per
              shard logged; (c) the S=4 cache saved through the
              CheckpointManager and restored onto S=4, 8 and one device:
              12 batches element-wise equal to the uninterrupted cache;
              (d) bench_shard's capacity scaling at dim 768 (16,384 rows a
              shard, S = 1-8: the layout's bytes a shard flat, the
              bytes the card holds measured beside) and lookup times over
              65,536 rows split S ways, logged; (e) K1-local against its
              plain version at every shape it ran, at N = 32 and 33 and
              on an all-invalid block, bit for bit against K1 over the
              whole mirror, and timed at the S=4 block (B = 4).
10. zoo     — the MoE + sliding-window kind and the VLM prefix-LM, after
              shard, once the qwen3 weights are freed: (a) mixtral-8x7b at
              full width (d 4,096, 8 experts of d_ff 14,336 top-2, 32/8
              heads of 128, window 4,096) cut to 8 of its 32 layers (93.4
              GB in bf16 is more than the card), seeded random weights,
              ModelEngine(n_slots=4, max_len=8192), a ring of 4,096 slots:
              four 4,608-token prompts (K4 with the window; the ring
              wraps in prefill), then 16 decode steps (K3 over the ring),
              once with the bf16 KV cache and once with the int8 one; the
              first prefill's and the first step's logits held against
              the plain layers at ZOO_RTOL (a routing flip between the two
              runs may be held with the kernel run's routing forced; the
              share of flipped tokens a layer is logged), and the window
              dropped from the plain prefill must exceed it; (b)
              paligemma-3b at full size (18 layers): lm.prefill of B = 2,
              256 seeded patch embeddings + 256 text tokens (K4: prefix
              256, Dh 256, one kv head), then 8 decode steps (K3: Dh 256,
              8 query heads a kv head), logits held the same way, the
              prefix made causal the fault; (c) for both, the K3/K4
              counters zeroed and read around the runs, every distinct
              call re-checked at its own arguments with the other
              phases', and a short torch.profiler trace of a prefill and
              two decode steps: busy ms, K4's/K3's share, the MoE's and
              its dispatch's share; prefill and decode ms and the peak
              memory logged; (d) the two other dense kinds at full size,
              qwen2.5-14b (48 layers, qkv biases) and command-r-35b (40
              layers, 64/8 heads, a tied 256,000-row embedding, 60.6 GB),
              each through ModelEngine(n_slots=4, max_len=4,352) with the
              bf16 and the int8 KV cache: four 4,096-token prompts, 16
              decode steps, the first prefill's (plain attention 1,024
              query rows at a time) and the first step's logits held at
              ZOO_RTOL, every K3/K4 call noted for the re-checks.
11. mla_encdec — the MLA kind and the encoder-decoder, after zoo, once its
              weights are freed: (a) minicpm3-4b at full size (62 layers,
              d 2,560, 40 heads, q_lora 768, kv_lora 256, Dq 64 + 32, Dv
              64, vocab 73,448, tied; 8.1 GB of seeded random bf16
              weights) through ModelEngine(n_slots=4, max_len=8192): four
              4,096-token prompts (K4's Dv mode on every layer), then 16
              decode steps with ``mla_absorb`` off (K/V materialised from
              the latent cache, K3's Dv mode) and the same 16 steps from
              the same state with it on (absorbed f32 products, no K3);
              the first prefill's logits and each form's first step held
              against the plain layers at ZOO_RTOL (plain prefill
              attention 1,024 query rows at a time), the two forms against
              each other, and a kv tile dropped from the plain prefill
              must exceed the limit; (b) deepseek-v2-236b at full width
              (d 5,120, 128 heads, Dq 128 + 64, Dv 128, kv_lora 512, 160
              experts of 1,536 top-6 + 2 shared) cut to 4 of its 60 layers
              (the dense layer 0 and 3 MoE layers; 471.5 GB in bf16 at
              full depth), the same engine run, routing flips between the
              kernel and plain runs logged; (c) whisper-base at full size
              (6 + 6 layers, d 512, 8 heads of 64, LayerNorm, ungated gelu):
              lm.prefill of B = 2, 1,500 seeded stub frames (K4
              non-causal) and 64 text tokens (K4 causal, then the
              cross-attention: K4 non-causal, 64 queries over 1,500 keys),
              then 16 decode steps (K3 over the self cache and over the
              1,500 cross positions), held the same way, the encoder made
              causal the fault; (d) for each, launch counters zeroed and
              read around every window, every distinct K3/K4 call
              re-checked with the other phases', and profiled prefill and
              decode: busy ms, K4's/K3's share, idle share, prefill and
              decode ms and peak memory logged.
12. ssm_hybrid — the SSM kind and the hybrid, after mla_encdec, once its
              weights are freed: (a) rwkv6-7b at full size (32 layers, d
              4,096, 64 heads of 64, d_ff 14,336, vocab 65,536; 7.6B
              seeded random bf16 params): its shortest prompt through
              lm.prefill and 4 decode steps with the WKV6 kernel (K5),
              the logits held against the plain step loop's in f32 (the
              weights widened) at 1e-3 of the largest and in bf16 at 0.1
              (above the floor that rounding noise sets), with every
              bf16 WKV6 call held against the plain loop on its own
              inputs, and the update applied before y (a planted fault)
              must exceed each limit; then
              ModelEngine(n_slots=4) with prompts of 2,048, 1,999, 1,537
              and 1,024 tokens (K5 over each prompt, zero state) and 16
              decode steps (K5 at B 4, L 1, the carried state); (b)
              zamba2-7b at full size (81 Mamba2 layers, d 3,584, d_inner
              7,168, 112 SSM heads of 64, state 64, conv 4, chunk 128, the
              shared block of 32 heads x 112 after every 6th layer, 13
              invocations, LoRA rank 64; 6.7B params) through
              ModelEngine(n_slots=4, max_len=8192): the first prompt's
              prefill and 4 decode steps held against the plain attention
              layers the same way, in bf16 at ZOO_RTOL, each head's last
              16 of 112 output columns dropped in prefill and decode the
              fault; four 4,096-token prompts (K4 at Dh 112), then 16
              decode steps (K3 at Dh 112); (c) the WKV6 and K3/K4
              counters zeroed and read around the engine runs, every
              distinct WKV6 call held against the plain loop at its own
              arguments (the K3/K4 calls go to the re-checks with the other
              phases'), a profiled prefill and two decode steps of each
              model (busy ms, WKV6's/K4's/K3's share, idle share), prefill
              and decode ms and peak memory logged; WKV6 timed at rwkv6's
              prefill and K4/K3 at zamba2's head dim 112 (in the timing
              child, below).
13. train   — the training path, after ssm_hybrid, once its weights are
              freed: (a) the attention backward's kernels
              (``csrc/flash_attention_bwd.cu``: the tiled pair, dQ then
              dK/dV; the f32 one-pass kernel, which ``ops.bwd_route``
              gives f32 calls with Lq and Lkv at most 64) against
              their plain version ``attention_bwd_ref``: the pair in f32
              and bf16 over every mask mode (causal, bidirectional,
              window, prefix, cross attention with Lq != Lkv, an explicit
              q_offset, masked rows), head dims 64, 112 and 128 at 1, 5
              and 8 query heads a kv head, at qwen3-14b's 4,096-token
              prefill (40/8 heads of 128; f32 at 1,024); the one-pass
              kernel over every mode at Lq, Lkv <= 64 and head dims 16,
              64, 100, 112 and 128 at G 1, 5 and 8, each call twice and
              bit-identical; both at the two trainers' shapes of (c) (the
              embedder's f32 B 48 x 24 tokens, 12 heads of 64,
              bidirectional: one pass; the reduced qwen3's bf16 B 8 x 128,
              4 heads of 16, causal), f32 within 1e-5 of the largest
              |gradient|, bf16 within 2^-7 |plain| + 2^-5 x the row's rms
              of the terms' root sum of squares; a kv tile dropped from
              (a)'s pass 2 and one from (b) must each exceed the limit (at
              256 and 4,096 causal tokens and at the reduced qwen3's
              shape), and at the embedder's 8 keys dropped from dQ's sum
              and 8 rows of dK zeroed; the counters zeroed and read
              around (a), whose f32 pair launches are the pair's
              ``sweep_launches`` (no main-path call reaches it); the WKV6
              backward (K5-bwd, ``csrc/wkv6_bwd.cu``) against
              ``wkv6_bwd_ref`` over WKV6_BWD_SWEEP in f32 and bf16 and at
              rwkv6-7b's 4,096 tokens, each call from the checkpoints K5
              writes and from none (K5 runs first), bit-identical; K5's y
              and state the same bits with checkpoint writes, its
              checkpoints against ``wkv6_ckpt_ref``; one step's dy
              dropped and checkpoints of other inputs must fail the
              limit; (b)
              qwen3-14b at full
              width cut to 4 of 40 layers (2.88 B params; remat on, bf16),
              B 1 x 4,096 tokens, chunked CE of 512: one step's loss, grad
              norm and every gradient leaf held against the same step with
              every attention call plain, then 4 steps of
              ``make_train_step`` with AdamW (lr 3e-3, warmup 1) on that
              fixed batch: the loss falls, the backward kernels launch at
              least twice a layer a step and the plain backward never;
              step ms, peak memory and a traced step (busy ms, idle share,
              the backward kernels' and K4's shares) logged; (c)
              ``launch.train --reduced --steps 10`` on the card (the loss
              decreases) and ``launch.train_embedder`` at the full
              siso-embedder in f32 for 60 steps (the dup/non-dup gap
              widens and stays positive; the f32 K4 and the one-pass
              backward every step, at least 12 launches a step; every f32
              backward call of (b)-(c) one pass), each step timed on the
              host and the last traced (busy ms, idle share, the
              backward's and K4's shares). Since PR 36 (b) also trains
              qwen2.5-14b, command-r-35b (2 layers), mixtral-8x7b (2
              layers, 4,608 tokens past its window; an MoE step held with
              the kernel step's routing forced where tokens flipped),
              zamba2-7b (12 layers: Dh 112, the SSD under autograd, each
              of the shared block's two invocations' LoRA gradient above
              0), whisper-base whole (6 + 6 layers: the cross-attention's
              backward; its cross-attention key bias, whose exact
              gradient is 0, held below TRAIN_ZERO_FLOOR of the tree's
              largest |gradient|), and (c) runs launch.train --reduced
              for all ten kinds.
14. parallel — the parallel training plane on virtual meshes of the
              card ([cuda:0] * N), after phase 13 and the main-path
              shape checks: (a) qwen3-14b at full width (4 layers) placed
              on a (data 2, model 2) mesh by param_specs(fsdp=True), every
              block its spec's shape, the gathers bit-exact, one copy of
              the weights on the card; the specs of every LM
              configuration on meta structs; (d) its 4 blocks over 4
              virtual pipeline stages (stage_spans), 4 microbatches of
              1 x 1,024, against the blocks in order (0.05 of the largest
              |output|; a microbatch sent past the next stage must fail);
              (b) the sharded train step on the (2, 2) mesh, global batch
              2 x 2,048 (1 x 2,048 a data rank), CE chunk 512, remat,
              AdamW: loss, grad norm and every mean-gradient leaf against
              make_train_step's on one device at TRAIN_*_RTOL; two steps
              from the same state give the same bits; K4 and the bf16
              backward pair launch, the plain backward never; host ms,
              busy ms, idle share and peak memory logged; (c) the two
              ranks' full-width gradients through the ring all-reduce
              (the same bits on both, their f32 sum; a skipped hop must
              fail), the int8 all-reduce (relative error < 0.05) and top-k
              with feedback at 0.01 (kept + residual == g + r); (e)
              moe_apply_shard_map on mixtral-8x7b's MoE layer over (2, 4)
              (expert parallel) and (2, 3) (the ffn sliced unevenly) and
              deepseek-v2's over (2, 4), at full width, against
              moe_apply(groups=2) within the bf16 row limit (one shard's
              partial dropped must fail); (f) ElasticRunner with the
              sharded step on the reduced qwen3 over 4 virtual devices, 2
              lost at step 3, a checkpoint every 2 steps, resume(): one
              remesh, the end state within the train tolerances of an
              uninterrupted run. The phase adds no kernel and leaves the
              kernels line as it was.
15. dryrun  — the dry-run against the card, after phase 14: (a)
              launch.dryrun.run_cell on the meta device for each step
              phase 13 (b) trained (one device, its cut configuration)
              and for phase 14 (b)'s sharded step (the virtual mesh
              traced whole): the predicted peak of live bytes beside
              torch.cuda.max_memory_allocated over the same step,
              qwen3-14b's two within DRYRUN_PEAK_RTOL; each kind's mfu,
              model_flops over (busy s x 989e12); (b) the three examples
              (examples/torch_*.py) on cuda as subprocesses, their lines
              logged, each named kernel counter above 0 (K1 and K2 for
              quickstart and serve_with_siso, K4-f32 and the one-pass
              backward for train_embedder).

Every kernel's timing (CUDA events, the plain version, the library call,
the bound, and the profiler's device time) is taken in one child process
of this script (``--timing-child``), started after phase 2's checks,
so that no earlier trace in the process can drop a kernel's record (late
traces lose them: tools/profiler_probe.py); K1-local's is taken in phase
9 on the served mirror's blocks.

The line before the last is a JSON object with one entry per kernel (K1's
shard-local mode, K3's int8 mode and K4's f32 mode, the embedder's call,
and both attention kernels' Dv mode, MLA's, their own entries, with
their own bounds; the WKV6 recurrence ``wkv6``, which no library call
computes; the attention backward's two kernels,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` (the tiled
pair, bf16, at qwen3-14b's prefill), their f32 instances
``flash_attention_bwd_dq_f32`` and ``flash_attention_bwd_dkv_f32`` (the
CUDA-core pair on 8 x 8 register micro-tiles with cp.async stages and
heavy-first grids, at phase 13 (a)'s 1,024 causal tokens, 40/8 heads of
128; no call of the main path reaches the f32 pair since the embedder's
went to the one-pass kernel, so their ``launches`` are 0 and only these
two entries are exempt from the launched-on-the-main-path check; (a)'s
correctness sweep, which must launch them, gives its count as
``sweep_launches``; they also carry ``parent_device_ms``, the pair before
its Hopper redesign, ``tools/attention_bwd_f32_parent.cu``, timed in turns
with them), each with the
bound of the products its own outputs need, and ``flash_attention_bwd_f32``, the one-pass kernel at the
embedder's call (launches phase 13's one-pass ones, the whole backward's
bound), each with SDPA's backward as its library call; the WKV6
backward ``wkv6_bwd`` and K5 with checkpoint writes ``wkv6_ckpt``
(rwkv6-7b's B 1 x 4,096, 64 heads of 64; no library call computes
either), which also carry ``parent_device_ms`` (K5-bwd's first design,
``tools/wkv6_bwd_probe.py``, timed in turns with it) and
``no_ckpt_device_ms`` (K5 without checkpoint writes at that shape);
K4-Dv's training instance, which writes the LSE,
``flash_attention_dv_lse`` (``no_lse_device_ms``: the serving instance in
turns with it; SDPA's training forward, which keeps the LSE too, its
library call); every
entry also carries ``device_ms``, the profiler's
device time, and each entry with a library call ``library_device_ms``,
that call's); the line
before it is the card's name and power limit; the last line is the device
JSON. Details go to DIR/chip_smoke.json (default
results/, relative to the repository root).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
D, N_ROWS = 768, 65536
N_HIST, MIN_CENTROIDS = 38000, 32768
ATOL = 1e-5     # 768-term fp32 dots of unit vectors in another summation
                # order differ by ~1e-7; neighbouring sims are ~1e-3 apart
H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores

TOPICS = {
    "caching": ["what is semantic caching", "explain semantic caching",
                "how does a semantic cache work", "define semantic caching"],
    "slo": ["what is an slo", "explain service level objectives",
            "service level objective meaning"],
    "llm": ["how do llms generate text", "explain llm decoding",
            "how does an llm produce output"],
    "weather": ["will it rain tomorrow in seoul",
                "seoul weather forecast tomorrow"],
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*a) -> None:
    print(*a, flush=True)


def gen(torch, seed: int):
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def far_start(n: int) -> int:
    """First row of the exact copies: the second-to-last 512-row tile, or
    the second half of a table no longer than one tile (the slo phase's
    cache plane)."""
    return max(n // 512 - 2, 1) * 512 if n >= 1024 else n // 2


def kernel_inputs(torch, B: int, seed: int, n: int = N_ROWS):
    """Unit rows with 10% invalid holes; each query has a near copy in tile
    0 (sim ~0.98) and an exact copy at ``far_start`` (sim 1.0), so early
    exit at theta 0.9 serves tile 0 and exact top-k the copy. Queries
    beyond the rows available share copies (only the last one keeps its
    exact copy)."""
    g = gen(torch, seed)
    rows = torch.randn((n, D), generator=g, device=DEV)
    rows /= rows.norm(dim=1, keepdim=True)
    valid = torch.rand((n,), generator=g, device=DEV) > 0.1
    q = torch.randn((max(B, 1), D), generator=g, device=DEV)
    q = (q / q.norm(dim=1, keepdim=True))[:B]
    if B:
        # 13 and 11 are odd, so up to 512 queries get distinct rows
        f0 = far_start(n)
        near = (7 + 13 * torch.arange(B, device=DEV)) % min(512, f0)
        far = f0 + (11 * torch.arange(B, device=DEV)) % min(512, n - f0)
        noisy = q + 0.2 * torch.nn.functional.normalize(
            torch.randn((B, D), generator=g, device=DEV), dim=1)
        rows[near] = noisy / noisy.norm(dim=1, keepdim=True)
        rows[far] = q
        valid[near] = True
        valid[far] = True
    return q.contiguous(), rows.contiguous(), valid


class Inputs:
    """One kernel_inputs draw with its int8 code plane."""

    def __init__(self, torch, ops, B: int, seed: int, n: int = N_ROWS):
        self.n = n
        self.q, self.rows, self.valid = kernel_inputs(torch, B, seed, n)
        codes, scales, _ = ops.quantize_rows(self.rows.cpu().numpy())
        self.codes = torch.tensor(codes, device=DEV)
        self.scales = torch.tensor(scales, device=DEV)


def compare(torch, ops, ref, fn: str, x: Inputs, k: int, early: bool,
            theta: float = 0.9, margin: float = 0.01) -> float:
    """One kernel call against its plain version on the same inputs;
    returns the largest sim difference."""
    if fn == "cosine_topk":
        kv, ki, kh = ops.cosine_topk(x.q, x.rows, k=k, valid=x.valid,
                                     theta=theta, early_exit=early,
                                     return_hit=True)
        pv, pi, ph = ref.cosine_topk_ref(x.q, x.rows, k, x.valid, theta,
                                         early)
        thr = theta
    else:
        kv, ki, kh = ops.cosine_topk_q8(x.q, x.codes, x.scales, k=k,
                                        valid=x.valid, theta=theta,
                                        margin=margin, early_exit=early,
                                        return_hit=True)
        pv, pi, ph = ref.cosine_topk_q8_ref(x.q, x.codes, x.scales, k,
                                            x.valid, theta, margin, early)
        thr = theta + margin
    torch.cuda.synchronize()
    B = x.q.shape[0]
    ctx = f"{fn} B={B} N={x.n} k={k} early={early} theta={theta}"
    check(kv.shape == (B, k) and ki.shape == (B, k) and kh.shape == (B,),
          f"{ctx}: shapes")
    check(torch.equal(ki, pi), f"{ctx}: indices differ")
    check(torch.equal(kh, ph), f"{ctx}: hit masks differ")
    fin = torch.isfinite(pv)
    check(torch.equal(fin, torch.isfinite(kv)), f"{ctx}: finiteness differs")
    e = float((kv[fin] - pv[fin]).abs().max()) if B else 0.0
    check(e <= ATOL, f"{ctx}: max abs err {e}")
    if B:
        served = ki[:, 0].cpu()
        if early and 0 < thr < 0.97:
            check(bool((served < 512).all()), f"{ctx}: early exit did not fire")
        elif not early and B <= min(512, x.n - far_start(x.n)):
            check(bool((served >= far_start(x.n)).all()),
                  f"{ctx}: exact top-k missed the copies")
    return e


def phase_kernels(torch, seed: int) -> dict:
    """Both kernels at D=768, N=65,536 over B in {0, 1, 4, 5, 8, 32, 33}
    (4 is the served batch; 5 and 33 are ragged against the query
    buckets), k in {1, 16}, early exit on and off."""
    from repro_torch.kernels.cosine_topk import ops, ref
    err = {"cosine_topk": 0.0, "cosine_topk_q8": 0.0}
    checks = 0
    for B in (0, 1, 4, 5, 8, 32, 33):
        x = Inputs(torch, ops, B, seed + B)
        for fn in err:
            for k in (1, 16):
                for early in (False, True):
                    err[fn] = max(err[fn],
                                  compare(torch, ops, ref, fn, x, k, early))
                    checks += 1
    log(f"[kernels] {checks} kernel-vs-plain comparisons agree "
        f"(indices and hit masks identical, sims within atol {ATOL}); "
        f"max abs err K1 {err['cosine_topk']:.3g}, "
        f"K2 {err['cosine_topk_q8']:.3g}")
    return err


class CallRecorder:
    """Stands in for the kernel ops module inside the semantic cache while
    the main path runs: it notes the arguments that decide each kernel
    call's work (B, N, k, early exit, theta, margin) and passes the call on
    to the real wrapper, which does its own launch counting."""

    def __init__(self, ops):
        self._ops = ops
        self.calls: set = set()

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def cosine_topk(self, q, rows, k=1, valid=None, theta=2.0,
                    early_exit=False, **kw):
        self.calls.add(("cosine_topk", q.shape[0], rows.shape[0], k,
                        bool(early_exit), float(theta), 0.0))
        return self._ops.cosine_topk(q, rows, k=k, valid=valid, theta=theta,
                                     early_exit=early_exit, **kw)

    def cosine_top1_local(self, q, rows, valid=None, **kw):
        self.calls.add(("cosine_top1_local", q.shape[0], rows.shape[0], 1,
                        False, 2.0, 0.0))
        return self._ops.cosine_top1_local(q, rows, valid, **kw)

    def cosine_topk_q8(self, q, codes, scales, k=1, valid=None, theta=2.0,
                       margin=0.0, early_exit=False, **kw):
        self.calls.add(("cosine_topk_q8", q.shape[0], codes.shape[0], k,
                        bool(early_exit), float(theta), float(margin)))
        return self._ops.cosine_topk_q8(q, codes, scales, k=k, valid=valid,
                                        theta=theta, margin=margin,
                                        early_exit=early_exit, **kw)


def phase_main_shapes(torch, calls: set, seed: int) -> dict:
    """Every distinct K1/K2 call of the main path, held against the plain
    version at its own B, N, k, early exit, theta and margin (K1-local's
    calls are the shard phase's own checks)."""
    from repro_torch.kernels.cosine_topk import ops, ref
    err = {"cosine_topk": 0.0, "cosine_topk_q8": 0.0}
    for fn, B, n, k, early, theta, margin in sorted(calls):
        if fn not in err:
            continue
        x = Inputs(torch, ops, B, seed + 7 * B + 1, n)
        err[fn] = max(err[fn], compare(torch, ops, ref, fn, x, k, early,
                                       theta, margin))
        log(f"[kernels] main-path call {fn} B={B} N={n} k={k} "
            f"early={early} theta={theta} margin={margin}: agrees with "
            f"the plain version")
    return err


def bound(fn: str, B: int, k: int, rows_needed: int, tiles_rows: int):
    """Least time for the work this input needs: bytes read once / written
    once over HBM rate vs fp32 FMA flops over the non-tensor fp32 peak."""
    row_bytes = D * 4 if fn == "cosine_topk" else D + 4   # codes + scale
    nbytes = (B * D * 4 + tiles_rows + rows_needed * row_bytes
              + B * k * 8 + B)
    flops = 2.0 * B * rows_needed * D
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch, seed: int) -> dict:
    """Times at serving shapes: random queries (no planted hits), so early
    exit never fires and every tile is needed, as for a batch that holds a
    miss. K1 as served (k=1, early exit on), K2 as served (k=16, off)."""
    from repro_torch.kernels.cosine_topk import ops, ref
    out = {}
    g = gen(torch, seed + 99)
    rows = torch.nn.functional.normalize(
        torch.randn((N_ROWS, D), generator=g, device=DEV), dim=1)
    valid = torch.rand((N_ROWS,), generator=g, device=DEV) > 0.1
    codes_np, scales_np, _ = ops.quantize_rows(rows.cpu().numpy())
    codes = torch.tensor(codes_np, device=DEV)
    scales = torch.tensor(scales_np, device=DEV)
    neg = torch.tensor(float("-inf"), device=DEV)
    for B in (1, 4, 8, 32):
        q = torch.nn.functional.normalize(
            torch.randn((B, D), generator=g, device=DEV), dim=1)
        for fn, k, early in (("cosine_topk", 1, True),
                             ("cosine_topk_q8", 16, False)):
            if fn == "cosine_topk":
                kern = lambda: ops.cosine_topk(q, rows, k=k, valid=valid,
                                               theta=0.95, early_exit=early,
                                               return_hit=True)
                plain = lambda: ref.cosine_topk_ref(q, rows, k, valid, 0.95,
                                                    early)
                lib = lambda: torch.topk(
                    torch.where(valid[None], q @ rows.T, neg), k, dim=1)
                sims = torch.where(valid[None], q @ rows.T, neg)
            else:
                kern = lambda: ops.cosine_topk_q8(q, codes, scales, k=k,
                                                  valid=valid, theta=0.95,
                                                  early_exit=early,
                                                  return_hit=True)
                plain = lambda: ref.cosine_topk_q8_ref(q, codes, scales, k,
                                                       valid, 0.95, 0.0,
                                                       early)
                lib = lambda: torch.topk(torch.where(
                    valid[None], (q @ codes.float().T) * scales, neg), k,
                    dim=1)
                sims = torch.where(valid[None],
                                   (q @ codes.float().T) * scales, neg)
            t_end = ref.tiles_needed(sims, 0.95, early)
            bn = ref.logical_block(N_ROWS)
            tiles_rows = min(t_end * bn, N_ROWS)
            rows_needed = int(valid[:tiles_rows].sum())
            b_ms, b_by = bound(fn, B, k, rows_needed, tiles_rows)
            rec = {"B": B, "k": k, "early_exit": early,
                   "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                   "library_ms": cuda_ms(torch, lib), "bound_ms": b_ms,
                   "bound_by": b_by, "tiles_needed": t_end,
                   "rows_needed": rows_needed}
            out.setdefault(fn, []).append(rec)
            log(f"[timing] {fn} B={B} k={k}: kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.4f} ms, library "
                f"{rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}, {b_ms / rec['ms']:.3f} of it)")
            if fn == "cosine_topk" or B == SPLIT_B:
                rec.update(topk_device_ms(torch, kern, fn))
                split = rec["device_kernels"]
                log(f"[timing] {fn} B={B}, torch.profiler: " + (
                    "; ".join(f"{n} {t:.4f} ms" for n, t in split.items())
                    + f"; {rec['device_ms']:.4f} ms on the device "
                      f"({b_ms / rec['device_ms']:.3f} of the bound)"
                    if split else
                    "no device activity recorded (not measured)"))
            if B == SPLIT_B:
                rec.update(library_device_ms(torch, lib))
                log(f"[timing] {fn} B={B}, library on the device: "
                    f"{rec['library_device_ms']} ms (records "
                    f"{rec['library_device_records']} of 10 calls)")
    return out


def library_device_ms(torch, lib) -> dict:
    """Device ms per call of the library yardstick ``lib`` (all the
    kernels one call launches), from a torch.profiler trace of 10 calls,
    None when the profiler records no device activity; and each kernel's
    record count in the trace."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    split, records = device_kernel_ms(torch, lib, iters=10)
    return {"library_device_ms": sum(split.values()) if split else None,
            "library_device_records": list(records.values())}


SPLIT_B = 4     # the served batch: K2 traced pass by pass there; K1 at
                # every batch


def topk_device_ms(torch, fn, name: str, iters: int = 10) -> dict:
    """Device ms per call of each of the kernel's launches (pass 1
    ``sims_tile_*`` and pass 2 ``merge_tiles``), from a torch.profiler
    trace of ``iters`` calls, with each launch's record count. One call
    launches these two and nothing else (no copy, cast or fill), but for
    K1-local's clamp of a miss's row."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    split, records = device_kernel_ms(torch, fn, iters=iters)
    if not split:
        return {"device_ms": None, "device_kernels": {}}
    local = name == "cosine_top1_local"
    names = sorted(n.split("(")[0].split("<")[0].replace("void ", "")
                   for n in split if not (local and "clamp" in n))
    check(names == ["ctk::merge_tiles", f"ctk::sims_tile_"
                    f"{'q8' if name == 'cosine_topk_q8' else 'f32'}"]
          and len(split) == 2 + local,
          f"[timing] {name}: one call launches {list(split)}, not its own "
          f"two passes{' and its clamp' if local else ''} alone")
    return {"device_ms": sum(split.values()),
            "device_kernels": {n.split("(")[0]: t for n, t in split.items()},
            "device_records": {n.split("(")[0]: c
                               for n, c in records.items()}}


# ---------------------------------------------------------------------------
# phase 2b: attention kernels (K3, K4) against their plain versions
# ---------------------------------------------------------------------------

ATT_ATOL_F32 = 2e-5   # the reference's own for f32 outputs: sums in
                      # another order
# bf16 outputs: |kernel - plain| <= 2^-7 |plain| + ATT_ROW_RTOL x the rms of
# plain's row (kernels.bf16_excess). K4 rounds P to bf16 at each kv tile's
# running max, its plain version at the row's final max: independent
# roundings of up to 2^-9 each, whose sum over the row's keys is about
# 0.002 of the row's rms (one standard deviation), so the largest of the
# 2e7 outputs at the prefill shape lies near 0.012. A kv tile dropped from
# a 4,096-key row moves it by about sqrt(64 / 4096) = 0.125 of the rms.
# K3 is f32 throughout, as is its plain version: only the summation order
# differs.
ATT_ROW_RTOL = {"flash_attention": 2.0 ** -5,
                "flash_attention_dv": 2.0 ** -5,
                "decode_attention": 2.0 ** -10,
                "decode_attention_int8": 2.0 ** -10,
                "decode_attention_dv": 2.0 ** -10}
# the attention kernels' entries: K4 bf16 and f32 apart (the f32 outputs are
# held at ATT_ATOL_F32, with no bf16 limit), and both kernels' Dv mode (a
# value head dim other than the q/k one: MLA) apart
ATT_KEYS = ("flash_attention", "flash_attention_f32", "flash_attention_dv",
            "decode_attention", "decode_attention_int8",
            "decode_attention_dv")
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
EMBED_SHAPE = dict(B=4, Lq=24, Lkv=24, H=12, Hkv=12, Dh=64)
PREFILL_SHAPE = dict(B=1, Lq=4096, Lkv=4096, H=40, Hkv=8, Dh=128)
DECODE_SHAPE = dict(B=4, H=40, Hkv=8, Dh=128)
DECODE_LENS = (4096, 32768)         # engine-long's prompt; decode_32k
DECODE_TIMED = ((8192, 4096),       # (cache length, kv_len): engine-long's
                (32768, 32768))     # layout; decode_32k
# the Dv mode at minicpm3-4b's shapes (Dq = 64 + 32, Dv = 64): its prefill
# of a 4,096-token prompt and its engine's decode (4 slots, Lc 8,192,
# kv_len 4,096, one kv head a query head)
DV_PREFILL_SHAPE = dict(B=1, Lq=4096, Lkv=4096, H=40, Hkv=40, Dh=96, Dv=64)
DV_DECODE_SHAPE = dict(B=4, H=40, Hkv=40, Dh=96, Dv=64)
DV_DECODE_TIMED = (8192, 4096)
# deepseek-v2-236b's decode at the same slots and lengths (128 heads, one kv
# head a query head, Dq 128 + 64, Dv 128), timed beside minicpm3's
DV_DEEPSEEK_DECODE_SHAPE = dict(B=4, H=128, Hkv=128, Dh=192, Dv=128)
# deepseek-v2-236b's (Dq = 128 + 64, Dv = 128) at fewer heads, for the checks
DV_DEEPSEEK = dict(Dh=192, Dv=128)
# deepseek-v2-236b's prefill of a 4,096-token prompt (128 heads, one kv
# head a query head), timed beside minicpm3's
DV_DEEPSEEK_PREFILL_SHAPE = dict(B=1, Lq=4096, Lkv=4096, H=128, Hkv=128,
                                 Dh=192, Dv=128)
# (Dq, Dv) of bf16 K4's persistent route and the lengths phase 2 holds it
# at: both sides of its 128-row q tiles and its 96-192-key kv tiles
PERSISTENT_PAIRS = ((96, 64), (112, 112), (192, 128))
PERSISTENT_LENGTHS = (1, 63, 65, 129, 193, 300, 4095)
FLASH_MODES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "window": dict(causal=True, window=100),
    "prefix": dict(causal=True, prefix_len=40),
    "offset-ragged": dict(causal=True, q_offset=150, kv_valid_len=[300, 97]),
    "right-aligned": dict(causal=True, Lq=77),
}


FLASH_SWEEP = (
    (dict(B=2, Lq=77, Lkv=333, H=4, Hkv=2, Dh=128), dict(causal=True)),
    (dict(B=2, Lq=300, Lkv=333, H=4, Hkv=2, Dh=128), dict(causal=False)),
    (dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1, Dh=128), dict(causal=True)),
    (dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1, Dh=128),
     dict(causal=True, window=300)),
    (dict(B=3, Lq=260, Lkv=260, H=40, Hkv=8, Dh=128),
     dict(causal=True, kv_valid_len=[260, 77, 129])),
)


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def flash_inputs(torch, B, Lq, Lkv, H, Hkv, Dh, dtype, seed, Dv=None):
    """q (B, Lq, H, Dh), k (B, Lkv, Hkv, Dh) and v (B, Lkv, Hkv, Dv or
    Dh)."""
    g = gen(torch, seed)
    return tuple(torch.randn(s, generator=g, device=DEV).to(dtype)
                 for s in ((B, Lq, H, Dh), (B, Lkv, Hkv, Dh),
                           (B, Lkv, Hkv, Dv or Dh)))


def decode_inputs(torch, B, H, Hkv, Dh, Lc, qdtype, int8, seed, Dv=None):
    """q (B, H, Dh), k cache (B, Lc, Hkv, Dh) and v cache (B, Lc, Hkv, Dv or
    Dh) in ``qdtype``, or int8 codes and f16 scales made by the model's
    quantizer."""
    from repro_torch.models import lm
    g = gen(torch, seed)
    q = torch.randn((B, H, Dh), generator=g, device=DEV).to(qdtype)
    k, v = (torch.randn((B, Lc, Hkv, d), generator=g, device=DEV)
            for d in (Dh, Dv or Dh))
    if not int8:
        return q, k.to(qdtype), v.to(qdtype), {}
    (kq, ks), (vq, vs) = lm.kv_quant(k), lm.kv_quant(v)
    return q, kq, vq, {"k_scale": ks, "v_scale": vs}


class Agreement:
    """Per kernel entry: the largest |kernel - plain| and the largest share
    of the bf16 limit used (``kernels.bf16_excess``) over its comparisons."""

    def __init__(self):
        self.err = dict.fromkeys(ATT_KEYS, 0.0)
        self.share = dict.fromkeys(ATT_KEYS, 0.0)
        self.n = 0

    def hold(self, torch, key: str, out, plain, ctx: str) -> None:
        from repro_torch.kernels import bf16_excess
        check(out.shape == plain.shape and out.dtype == plain.dtype,
              f"{ctx}: shape or dtype")
        check(bool(torch.isfinite(out).all()), f"{ctx}: non-finite output")
        e = float((out.float() - plain.float()).abs().max())
        self.err[key] = max(self.err[key], e)
        self.n += 1
        if out.dtype == torch.float32:
            check(e <= ATT_ATOL_F32, f"{ctx}: max abs err {e}")
            return
        x = bf16_excess(out, plain, ATT_ROW_RTOL[key])
        self.share[key] = max(self.share[key], x)
        check(x <= 1.0, f"{ctx}: max abs err {e}, {x:.3g} of the bf16 limit")

    def merge(self, other: "Agreement") -> None:
        for key in self.err:
            self.err[key] = max(self.err[key], other.err[key])
            self.share[key] = max(self.share[key], other.share[key])
        self.n += other.n


def compare_flash(torch, agree: Agreement, shape: dict, dtype, seed: int,
                  **kw) -> None:
    """K4 against its plain version, which rounds P as the kernel does."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = flash_inputs(torch, **shape, dtype=dtype, seed=seed)
    if kw.get("kv_valid_len") is not None:
        kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], device=DEV)
    out = ops.flash_attention(q, k, v, **kw)
    plain = ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    key = ("flash_attention_dv" if v.shape[-1] != q.shape[-1]
           else "flash_attention_f32" if dtype == torch.float32
           else "flash_attention")
    agree.hold(torch, key, out, plain,
               f"flash_attention {shape} {_dtype_name(dtype)} {kw}")


def compare_decode(torch, agree: Agreement, shape: dict, Lc: int, kv_len,
                   qdtype, int8: bool, seed: int) -> None:
    from repro_torch.kernels.decode_attention import ops, ref
    q, k, v, sc = decode_inputs(torch, **shape, Lc=Lc, qdtype=qdtype,
                                int8=int8, seed=seed)
    kv_len = torch.tensor(kv_len, device=DEV)
    out = ops.decode_attention(q, k, v, kv_len, **sc)
    plain = ref.decode_attention_ref(q, k, v, kv_len, **sc)
    torch.cuda.synchronize()
    key = ("decode_attention_dv" if v.shape[-1] != q.shape[-1]
           else "decode_attention_int8" if int8 else "decode_attention")
    agree.hold(torch, key,
               out, plain, f"decode_attention {shape} Lc={Lc} kv_len="
               f"{kv_len.tolist()} q {_dtype_name(qdtype)} cache "
               f"{_dtype_name(k.dtype)}")


def log_agreement(what: str, agree: Agreement) -> None:
    log(f"[kernels] {agree.n} {what} agree with the plain version (f32 "
        f"atol {ATT_ATOL_F32}; bf16 2^-7 |plain| + 2^-5 (K4) or 2^-10 (K3) "
        f"x the row's rms): " + "; ".join(
            f"{key} max abs err {agree.err[key]:.3g}, largest share of the "
            f"bf16 limit {agree.share[key]:.3g}" for key in agree.err))


def phase_attention_kernels(torch, seed: int) -> Agreement:
    """K4 over every mask mode in f32 and bf16 (B=2, L=300, H=8/2, Dh=128)
    and at the embedder's and the engine prefill's shapes; K3 with f32,
    bf16 and int8 caches, ragged kv_len, at the engine decode's shape."""
    agree = Agreement()
    for i, (mode, kw) in enumerate(FLASH_MODES.items()):
        kw = dict(kw)
        shape = dict(B=2, Lq=kw.pop("Lq", 300), Lkv=300, H=8, Hkv=2, Dh=128)
        for dtype in (torch.float32, torch.bfloat16):
            compare_flash(torch, agree, shape, dtype, seed + 10 + i, **kw)
    # bf16 K4 against its tiles (128 q rows, 128 keys in a 2-stage ring):
    # ragged edges, a ring that wraps four times, qwen3's 40/8 heads
    for i, (shape, kw) in enumerate(FLASH_SWEEP):
        compare_flash(torch, agree, shape, torch.bfloat16, seed + 50 + i,
                      **kw)
    compare_flash(torch, agree, EMBED_SHAPE, torch.float32, seed + 20,
                  causal=False)
    compare_flash(torch, agree, PREFILL_SHAPE, torch.bfloat16, seed + 21,
                  causal=True)
    compare_flash(torch, agree, PREFILL_SHAPE, torch.float32, seed + 22,
                  causal=True)
    B = DECODE_SHAPE["B"]
    for Lc in DECODE_LENS:
        lens = [Lc, Lc - 1, Lc // 2 + 3, 1][:B]
        for qdtype, int8 in ((torch.bfloat16, False), (torch.float32, False),
                             (torch.bfloat16, True), (torch.float32, True)):
            compare_decode(torch, agree, DECODE_SHAPE, Lc, lens, qdtype,
                           int8, seed + Lc)
    # the Dv mode: minicpm3's (Dq 96, Dv 64) and deepseek-v2's (192, 128)
    # head dims, bf16 and f32, ragged against the tiles, then at minicpm3's
    # prefill and decode shapes
    for i, dims in enumerate((dict(Dh=96, Dv=64), DV_DEEPSEEK)):
        for dtype in (torch.bfloat16, torch.float32):
            for j, kw in enumerate((dict(causal=True), dict(causal=False),
                                    dict(causal=True, q_offset=150,
                                         kv_valid_len=[300, 97]))):
                compare_flash(torch, agree, dict(B=2, Lq=300, Lkv=300, H=8,
                                                 Hkv=8, **dims), dtype,
                              seed + 60 + 3 * i + j, **dict(kw))
            compare_decode(torch, agree, dict(B=4, H=8, Hkv=8, **dims), 700,
                           [700, 256, 1, 0], dtype, False, seed + 70 + i)
    compare_flash(torch, agree, DV_PREFILL_SHAPE, torch.bfloat16, seed + 72,
                  causal=True)
    Lc, n_kv = DV_DECODE_TIMED
    compare_decode(torch, agree, DV_DECODE_SHAPE, Lc,
                   [n_kv, n_kv + 1, n_kv + 7, 1], torch.bfloat16, False,
                   seed + 73)
    # zamba2's shared block: 32 heads of 112 (MHA), K4 padding q, k and v
    # to 128, K3 its tile rows (bf16; f32 on its generic kernel); ragged
    # against the tiles, then at its prefill and decode shapes
    for dtype in (torch.bfloat16, torch.float32):
        for j, kw in enumerate((dict(causal=True),
                                dict(causal=True, q_offset=0,
                                     kv_valid_len=[300, 97]))):
            compare_flash(torch, agree, dict(B=2, Lq=300, Lkv=300, H=32,
                                             Hkv=32, Dh=112), dtype,
                          seed + 80 + j, **kw)
        compare_decode(torch, agree, dict(ZAMBA_DECODE_SHAPE), 700,
                       [700, 256, 1, 0], dtype, False, seed + 82)
    compare_flash(torch, agree, ZAMBA_PREFILL_SHAPE, torch.bfloat16,
                  seed + 83, causal=True)
    # bf16's persistent route (ops.fwd_route: zamba2's 112 and MLA's pairs
    # at exact widths; 128-row q tiles, kv tiles of 192, 128 or 96 keys):
    # lengths on both sides of the tiles' edges, a ragged kv_valid_len
    # with a q_offset, a window and a prefix, 2 query heads a kv head
    for i, (dq, dv) in enumerate(PERSISTENT_PAIRS):
        for j, L in enumerate(PERSISTENT_LENGTHS):
            for k, kw in enumerate((
                    dict(causal=True),
                    dict(causal=True, q_offset=L // 3,
                         kv_valid_len=[L, (L + 1) // 3]),
                    dict(causal=True, window=100, prefix_len=40))):
                compare_flash(torch, agree, dict(B=2, Lq=L, Lkv=L, H=8,
                                                 Hkv=4, Dh=dq, Dv=dv),
                              torch.bfloat16, seed + 500 + 100 * i + 10 * j
                              + k, **kw)
    Lc, n_kv = ZAMBA_DECODE_TIMED
    compare_decode(torch, agree, ZAMBA_DECODE_SHAPE, Lc,
                   [n_kv, n_kv + 1, n_kv + 7, 1], torch.bfloat16, False,
                   seed + 84)
    log_agreement("attention kernel-vs-plain comparisons", agree)
    return agree


FAULT_TILE = 64     # half of K4's 128-key kv tile; K3's fault drops 256
                    # positions, four of its 64-position chunk steps


def flash_tile_dropped(torch, q, k, v):
    """Causal prefill (Lq == Lkv) through K4's plain version with one kv
    tile (keys L/2 .. L/2 + 64) left out of the last quarter of the query
    rows: a planted fault that the checks must fail. v may be narrower than
    q/k (the Dv mode)."""
    from repro_torch.kernels.flash_attention import ref
    L = q.shape[1]
    lo, r0 = L // 2, 3 * L // 4
    out = ref.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)

    def holed(x):
        return torch.cat([x[:, :lo], x[:, lo + FAULT_TILE:]], dim=1)
    # rows r0.. see every key before the hole; shifting the positions of
    # the later keys and of the rows by the hole's width keeps causality
    out[:, r0:] = ref.attention_ref(q[:, r0:], holed(k), holed(v),
                                    causal=True, q_offset=r0 - FAULT_TILE,
                                    p_dtype=v.dtype)
    return out


def phase_planted_faults(torch, seed: int) -> dict:
    """The bf16 limit must fail a dropped kv tile: K4 at the engine
    prefill's shape (and at minicpm3's and zamba2's) with one 64-key tile
    left out of the last quarter of the rows, K3 at decode_32k's kv length
    (and minicpm3's decode) with one 256-position split left out. Plain
    versions only; the readings are logged."""
    from repro_torch.kernels import bf16_excess
    from repro_torch.kernels.decode_attention import ref as dr
    from repro_torch.kernels.flash_attention import ref as fr
    q, k, v = flash_inputs(torch, **PREFILL_SHAPE, dtype=torch.bfloat16,
                           seed=seed + 40)
    plain = fr.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)
    bad = flash_tile_dropped(torch, q, k, v)
    out = {"flash_attention": (
        bf16_excess(bad, plain, ATT_ROW_RTOL["flash_attention"]),
        float((bad.float() - plain.float()).abs().max()))}
    del q, k, v, plain, bad
    Lc = DECODE_LENS[-1]
    q, k, v, _ = decode_inputs(torch, **DECODE_SHAPE, Lc=Lc,
                               qdtype=torch.bfloat16, int8=False,
                               seed=seed + 41)
    kv_len = torch.full((DECODE_SHAPE["B"],), Lc, device=DEV)
    plain = dr.decode_attention_ref(q, k, v, kv_len)
    split = 256
    lo = Lc // 2
    holed = [torch.cat([x[:, :lo], x[:, lo + split:]], dim=1) for x in (k, v)]
    bad = dr.decode_attention_ref(q, *holed, kv_len - split)
    out["decode_attention"] = (
        bf16_excess(bad, plain, ATT_ROW_RTOL["decode_attention"]),
        float((bad.float() - plain.float()).abs().max()))
    del q, k, v, plain, bad, holed
    # the Dv mode at minicpm3's prefill and decode shapes
    q, k, v = flash_inputs(torch, **DV_PREFILL_SHAPE, dtype=torch.bfloat16,
                           seed=seed + 42)
    plain = fr.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)
    bad = flash_tile_dropped(torch, q, k, v)
    out["flash_attention_dv"] = (
        bf16_excess(bad, plain, ATT_ROW_RTOL["flash_attention_dv"]),
        float((bad.float() - plain.float()).abs().max()))
    del q, k, v, plain, bad
    # zamba2's head dim 112 (the persistent route, not MLA's Dv mode)
    q, k, v = flash_inputs(torch, **ZAMBA_PREFILL_SHAPE, dtype=torch.bfloat16,
                           seed=seed + 44)
    plain = fr.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)
    bad = flash_tile_dropped(torch, q, k, v)
    out["flash_attention_dh112"] = (
        bf16_excess(bad, plain, ATT_ROW_RTOL["flash_attention"]),
        float((bad.float() - plain.float()).abs().max()))
    del q, k, v, plain, bad
    Lc, n_kv = DV_DECODE_TIMED
    q, k, v, _ = decode_inputs(torch, **DV_DECODE_SHAPE, Lc=Lc,
                               qdtype=torch.bfloat16, int8=False,
                               seed=seed + 43)
    kv_len = torch.full((DV_DECODE_SHAPE["B"],), n_kv, device=DEV)
    plain = dr.decode_attention_ref(q, k, v, kv_len)
    holed = [torch.cat([x[:, :n_kv // 2], x[:, n_kv // 2 + split:]], dim=1)
             for x in (k, v)]
    bad = dr.decode_attention_ref(q, *holed, kv_len - split)
    out["decode_attention_dv"] = (
        bf16_excess(bad, plain, ATT_ROW_RTOL["decode_attention_dv"]),
        float((bad.float() - plain.float()).abs().max()))
    for key, (x, e) in out.items():
        check(x > 1.0, f"[kernels] the bf16 limit passes a planted fault in "
                       f"{key}: {x:.3g} of the limit")
        log(f"[kernels] planted fault in {key} (one kv tile dropped): "
            f"{x:.3g} times the bf16 limit, max abs {e:.3g}")
    return out


def att_bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_attention_timing(torch, seed: int) -> dict:
    """K4 at the embedder's shape (f32, bidirectional) and the engine
    prefill's (bf16, causal), K3 at the engine decode's (bf16 and int8
    caches; kv_len 4,096 in an 8,192-position cache, engine-long's
    layout, and 32,768 in a full one): kernel, plain version, bound and
    scaled_dot_product_attention (a yardstick; it takes no int8 cache, and
    is given the kv_len mask). The bound counts each input that the work
    needs read once and the output written once: for causal prefill only
    the unmasked half of the scores, for decode the first kv_len
    positions."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da, ref as dr
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    out = {}
    for label, shape, dtype, causal in (
            ("embedder", EMBED_SHAPE, torch.float32, False),
            ("prefill", PREFILL_SHAPE, torch.bfloat16, True)):
        q, k, v = flash_inputs(torch, **shape, dtype=dtype, seed=seed + 31)
        B, L, H, Hkv, Dh = (shape[x] for x in ("B", "Lq", "H", "Hkv", "Dh"))
        esz = q.element_size()
        nbytes = esz * (2 * B * L * H * Dh + 2 * B * L * Hkv * Dh)
        pairs = L * (L + 1) // 2 if causal else L * L
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
        b_ms, b_by = att_bound(nbytes, 4.0 * B * H * Dh * pairs, peak)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = {"shape": shape, "dtype": _dtype_name(dtype), "causal": causal,
               "ms": cuda_ms(torch, lambda: fa.flash_attention(
                   q, k, v, causal=causal)),
               "plain_ms": cuda_ms(torch, lambda: fr.attention_ref(
                   q, k, v, causal=causal)),
               "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv)),
               "bound_ms": b_ms, "bound_by": b_by}
        rec["tflops"] = 4.0 * B * H * Dh * pairs / rec["ms"] / 1e9
        out[f"flash_attention/{label}"] = rec
        log(f"[timing] flash_attention {label} {shape} "
            f"{rec['dtype']}: kernel {rec['ms']:.4f} ms "
            f"({rec['tflops']:.1f} TFLOP/s), plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); the kernel takes "
            f"{b_ms / rec['ms']:.3f} of its bound")
        # device time beside the events' (which time the wrapper's host
        # work too, most of a call this short)
        rec.update(flash_device_ms(
            torch, lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv),
            fa.fwd_route(dtype, Dh, Dh), label))
        log(f"[timing] flash_attention {label}, torch.profiler: "
            + ("not measured (no profiler activity)"
               if rec["device_ms"] is None else
               f"kernel {rec['device_ms']:.4f} ms on the device "
               f"({b_ms / rec['device_ms']:.3f} of the bound) in "
               f"{list(rec['device_kernels'])}, library "
               f"{rec['library_device_ms']:.4f} ms in its kernels "
               f"{rec['library_kernels']}"))
    B, H, Hkv, Dh = (DECODE_SHAPE[x] for x in ("B", "H", "Hkv", "Dh"))
    for Lc, n_kv in DECODE_TIMED:
        for int8 in (False, True):
            q, k, v, sc = decode_inputs(torch, **DECODE_SHAPE, Lc=Lc,
                                        qdtype=torch.bfloat16, int8=int8,
                                        seed=seed + 32)
            kv_len = torch.full((B,), n_kv, device=DEV)
            row = Hkv * Dh * k.element_size() + (Hkv * 2 if int8 else 0)
            nbytes = 2 * B * H * Dh * 2 + 2 * B * n_kv * row + B * 4
            b_ms, b_by = att_bound(nbytes, 4.0 * B * H * Dh * n_kv,
                                   H100_BF16_FLOPS)
            name = "decode_attention_int8" if int8 else "decode_attention"
            lib = None
            if not int8:
                qt = q[:, :, None]
                kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                mask = (torch.arange(Lc, device=DEV)[None, :]
                        < kv_len[:, None])[:, None, None, :]
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
                lib = cuda_ms(torch, sdpa)
            call = lambda: da.decode_attention(q, k, v, kv_len, **sc)
            rec = {"Lc": Lc, "kv_len": n_kv, "ms": cuda_ms(torch, call),
                   "plain_ms": cuda_ms(torch, lambda: dr.decode_attention_ref(
                       q, k, v, kv_len, **sc)),
                   "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
            rec.update(decode_device_ms(torch, call, name))
            if lib is not None:
                rec.update(library_device_ms(torch, sdpa))
            out[f"{name}/{Lc}/{n_kv}"] = rec
            dev_ms = rec["device_ms"]
            log(f"[timing] {name} B={B} H={H}/{Hkv} Dh={Dh} Lc={Lc} "
                f"kv_len={n_kv}: "
                f"kernel {rec['ms']:.4f} ms (CUDA events), "
                + ("device not measured (no profiler activity)"
                   if dev_ms is None else
                   f"{dev_ms:.4f} ms on the device "
                   f"({b_ms / dev_ms:.3f} of the bound)")
                + f", plain {rec['plain_ms']:.4f} ms, library "
                f"{'n/a (no int8 cache)' if lib is None else f'{lib:.4f} ms'}"
                + ("" if lib is None else
                   f" ({rec['library_device_ms']} ms on the device)")
                + f", bound {b_ms:.4f} ms ({b_by}); device kernels "
                f"{rec['device_kernels']}")
            del q, k, v, sc
    out.update(dv_timing(torch, seed))
    return out


def dv_timing(torch, seed: int) -> dict:
    """Both kernels' Dv mode at minicpm3's shapes (DV_PREFILL_SHAPE, causal;
    DV_DECODE_SHAPE at Lc 8,192 and kv_len 4,096), K4's at deepseek-v2's
    prefill (DV_DEEPSEEK_PREFILL_SHAPE) and K3's at deepseek-v2's decode
    (DV_DEEPSEEK_DECODE_SHAPE): kernel, plain version, bound and
    scaled_dot_product_attention, which takes a value head dim of its own
    (a yardstick; the port never calls it). The bound counts q, k and v
    read once (K3: the first kv_len positions) and the output written
    once; prefill's operations 2 H (Dq + Dv) over the unmasked (query,
    key) pairs, decode's 2 B H kv_len (Dq + Dv)."""
    out = {"flash_attention_dv/prefill": dv_prefill_timing(
        torch, DV_PREFILL_SHAPE, "Dv prefill", seed + 33)}
    out["flash_attention_dv_lse"] = dv_lse_timing(torch, DV_PREFILL_SHAPE,
                                                  seed + 33)
    out["flash_attention_dv/deepseek_prefill"] = dv_prefill_timing(
        torch, DV_DEEPSEEK_PREFILL_SHAPE, "Dv prefill deepseek-v2", seed + 35)
    Lc, n_kv = DV_DECODE_TIMED
    for key, sh in (("decode_attention_dv", DV_DECODE_SHAPE),
                    ("decode_attention_dv_deepseek",
                     DV_DEEPSEEK_DECODE_SHAPE)):
        out[f"{key}/{Lc}/{n_kv}"] = dv_decode_timing(torch, sh, Lc, n_kv,
                                                     seed + 34)
    return out


def dv_prefill_timing(torch, sh: dict, label: str, seed: int) -> dict:
    """K4's Dv mode at ``sh`` (causal): kernel (CUDA events and the
    profiler's device time; the call must launch ``ops.fwd_route``'s
    instance alone), plain version, bound and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    B, L, H, Hkv, Dq, Dv = (sh[x] for x in ("B", "Lq", "H", "Hkv", "Dh",
                                            "Dv"))
    q, k, v = flash_inputs(torch, **sh, dtype=torch.bfloat16, seed=seed)
    nbytes = 2 * B * L * (H * Dq + Hkv * Dq + Hkv * Dv + H * Dv)
    pairs = L * (L + 1) // 2
    flops = 2.0 * B * H * (Dq + Dv) * pairs
    b_ms, b_by = att_bound(nbytes, flops, H100_BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    call = lambda: fa.flash_attention(q, k, v, causal=True)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    rec = {"shape": sh, "dtype": "bfloat16", "causal": True,
           "ms": cuda_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: fr.attention_ref(
               q, k, v, causal=True, p_dtype=v.dtype), iters=5, warmup=1),
           "library_ms": cuda_ms(torch, sdpa),
           "bound_ms": b_ms, "bound_by": b_by}
    rec["tflops"] = flops / rec["ms"] / 1e9
    rec.update(flash_device_ms(torch, call, sdpa,
                               fa.fwd_route(torch.bfloat16, Dq, Dv), label))
    log(f"[timing] flash_attention_dv {label} {sh} bf16: kernel "
        f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s), plain "
        f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); the kernel takes "
        f"{b_ms / rec['ms']:.3f} of its bound; device "
        + ("not measured" if rec["device_ms"] is None else
           f"{rec['device_ms']:.4f} ms ({b_ms / rec['device_ms']:.3f} of "
           f"the bound) in {list(rec['device_kernels'])}, library "
           f"{rec['library_device_ms']} ms in {rec['library_kernels']}"))
    return rec


def dv_lse_timing(torch, sh: dict, seed: int) -> dict:
    """K4's training forward at minicpm3's prefill (``sh``, causal): the
    instance that also writes each row's LSE for the backward
    (``flash_bf16_persistent_lse<96, 64, 192>``) beside the serving one on
    the same inputs, and SDPA's training forward (q, k and v requiring
    grad: the one PyTorch call that computes O and keeps each row's
    logsumexp for its backward), in turns (serving, training, SDPA, SDPA,
    training, serving; CUDA events and the profiler's device time, each
    K4 call launching its own instance alone); its output the same bits as
    the serving kernel's. The plain version is ``ref.attention_ref`` and
    ``ref.attention_lse``; the bound the serving kernel's, its bytes plus
    the LSE's (B H Lq f32 written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    B, L, H, Hkv, Dq, Dv = (sh[x] for x in ("B", "Lq", "H", "Hkv", "Dh",
                                            "Dv"))
    q, k, v = flash_inputs(torch, **sh, dtype=torch.bfloat16, seed=seed)
    serve = lambda: fa._forward(q, k, v, True, None, 0, 0, None)
    train = lambda: fa._forward(q, k, v, True, None, 0, 0, None,
                                with_lse=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    check(sdpa().grad_fn is not None, "[timing] SDPA's training forward "
                                      "keeps no graph")
    out, lse = train()
    check(torch.equal(out, serve()), "[timing] K4-Dv's output moves with "
                                     "the LSE write")
    del out, lse
    lse_bytes = 4 * B * H * fr.lse_rows(L)
    nbytes = 2 * B * L * (H * Dq + Hkv * Dq + Hkv * Dv + H * Dv) + lse_bytes
    flops = 2.0 * B * H * (Dq + Dv) * (L * (L + 1) // 2)
    b_ms, b_by = att_bound(nbytes, flops, H100_BF16_FLOPS)
    fns = {"serve": serve, "train": train, "sdpa": sdpa}
    ev = {name: [] for name in fns}
    dev = {name: [] for name in fns}
    lib_kernels = {}
    for name in ("serve", "train", "sdpa", "sdpa", "train", "serve"):
        ev[name].append(cuda_ms(torch, fns[name]))
        own = device_kernel_ms(torch, fns[name], iters=20)[0]
        dev[name].append(sum(own.values()) if own else None)
        if name == "sdpa":
            lib_kernels = {n.split("(")[0][:60]: t for n, t in own.items()}
            continue
        want = "flash_bf16_persistent_lse<96, 64, 192>" if name == "train" \
            else "flash_bf16_persistent<96, 64, 192>"
        check(len(own) == 1 and want in next(iter(own)),
              f"[timing] K4-Dv {name}: one call launches {list(own)}, not "
              f"{want} alone")
    rec = {"shape": sh, "dtype": "bfloat16", "causal": True,
           "ms": statistics.mean(ev["train"]),
           "no_lse_ms": statistics.mean(ev["serve"]),
           "device_ms": statistics.mean(dev["train"]),
           "no_lse_device_ms": statistics.mean(dev["serve"]),
           "device_turns": dev, "lse_bytes": lse_bytes,
           "plain_ms": cuda_ms(torch, lambda: (
               fr.attention_ref(q, k, v, causal=True, p_dtype=v.dtype),
               fr.attention_lse(q, k, causal=True)), iters=3, warmup=1),
           "library_ms": statistics.mean(ev["sdpa"]),
           "library_device_ms": None if None in dev["sdpa"] else
           statistics.mean(dev["sdpa"]),
           "library_kernels": lib_kernels,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[timing] flash_attention_dv_lse {sh} bf16 (K4's training forward, "
        f"the LSE written): {rec['ms']:.4f} ms (CUDA events), "
        f"{rec['device_ms']:.4f} ms on the device, against the serving "
        f"instance's {rec['no_lse_ms']:.4f} ms, {rec['no_lse_device_ms']:.4f}"
        f" ms on the device, and SDPA's training forward's "
        f"{rec['library_ms']:.4f} ms, {rec['library_device_ms']} ms on the "
        f"device in {lib_kernels} (turns {dev}); the LSE {lse_bytes:,} B; "
        f"plain {rec['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / rec['device_ms']:.3f} of it")
    return rec


def dv_decode_timing(torch, sh: dict, Lc: int, n_kv: int, seed: int) -> dict:
    """K3's Dv mode at ``sh`` (kv_len ``n_kv`` of ``Lc``): kernel, plain,
    bound, scaled_dot_product_attention and device ms, and the splits the
    fast kernel's grid took (``last_n_split``; 0 would be the generic
    kernel, which fails the run)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as da, ref as dr
    B, H, Hkv, Dq, Dv = (sh[x] for x in ("B", "H", "Hkv", "Dh", "Dv"))
    q, k, v, _ = decode_inputs(torch, **sh, Lc=Lc, qdtype=torch.bfloat16,
                               int8=False, seed=seed)
    kv_len = torch.full((B,), n_kv, device=DEV)
    nbytes = 2 * B * H * (Dq + Dv) + 2 * B * n_kv * Hkv * (Dq + Dv) + B * 8
    b_ms, b_by = att_bound(nbytes, 2.0 * B * H * n_kv * (Dq + Dv),
                           H100_BF16_FLOPS)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Lc, device=DEV)[None, :]
            < kv_len[:, None])[:, None, None, :]
    call = lambda: da.decode_attention(q, k, v, kv_len)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    call()
    n_split = dk.last_n_split.value
    check(n_split > 0, f"[timing] decode_attention_dv {sh}: the generic "
                       f"kernel ran, not the fast one")
    rec = {"shape": sh, "Lc": Lc, "kv_len": n_kv, "n_split": n_split,
           "ms": cuda_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: dr.decode_attention_ref(
               q, k, v, kv_len)),
           "library_ms": cuda_ms(torch, sdpa), "bound_ms": b_ms,
           "bound_by": b_by}
    rec.update(decode_device_ms(torch, call, "decode_attention_dv"))
    rec.update(library_device_ms(torch, sdpa))
    log(f"[timing] decode_attention_dv B={B} H={H}/{Hkv} Dq={Dq} Dv={Dv} "
        f"Lc={Lc} kv_len={n_kv}: kernel {rec['ms']:.4f} ms (CUDA events), "
        + ("device not measured" if rec["device_ms"] is None else
           f"{rec['device_ms']:.4f} ms on the device "
           f"({b_ms / rec['device_ms']:.3f} of the bound)")
        + f", plain {rec['plain_ms']:.4f} ms, library "
        f"{rec['library_ms']:.4f} ms ({rec['library_device_ms']} ms on the "
        f"device), bound {b_ms:.4f} ms ({b_by}); last_n_split {n_split}; "
        f"device kernels {rec['device_kernels']}")
    return rec


def flash_device_ms(torch, call, lib, kernel: str, label: str) -> dict:
    """A K4 call and scaled_dot_product_attention on the same inputs,
    device ms per call from torch.profiler traces (mean of 20 calls). One
    K4 call launches its own kernel (``kernel``, the instance
    ``ops.fwd_route`` names, in its name) and nothing else: no fill, copy
    or second pass."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    own, other = (device_kernel_ms(torch, f, iters=20)[0]
                  for f in (call, lib))
    check(not own or (len(own) == 1 and kernel in next(iter(own))),
          f"[timing] flash_attention {label}: one call launches "
          f"{list(own)}, not its {kernel} kernel alone")
    return {"device_ms": sum(own.values()) if own else None,
            "device_kernels": {n.split("(")[0]: t for n, t in own.items()},
            "library_device_ms": sum(other.values()) if other else None,
            "library_kernels": {n.split("(")[0][:60]: t
                                for n, t in other.items()}}


def decode_device_ms(torch, call, name: str) -> dict:
    """K3's device ms per call from a torch.profiler trace (the int64
    kv_len the timing passes included), and the kernels one call launches:
    K3 launches one (two on its generic path) and nothing else, no
    conversion or fill."""
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    split, _ = device_kernel_ms(torch, call, iters=10)
    if not split:
        return {"device_ms": None, "device_kernels": {}}
    check(len(split) <= 2 and all("da::decode" in n for n in split),
          f"[timing] {name}: one call launches {list(split)}, not K3's "
          f"kernel alone")
    return {"device_ms": sum(split.values()),
            "device_kernels": {n.split("(")[0]: t for n, t in split.items()}}


class OpsRecorder:
    """Stands in for a kernel's ops module (K4's or K3's inside
    ``models.layers``, WKV6's inside ``models.ssm``) while the main path
    runs: notes the arguments that decide each call's work (shapes,
    dtypes, masks; K3's kv_len and the largest |state| WKV6 was given are
    kept on the card and read after the stream) and passes the call on to
    the real wrapper, which does its own launch counting."""

    def __init__(self, ops):
        self._ops = ops
        self.calls: list = []
        self.n_split: list = []     # K3: ``last_n_split`` after each call

    def flash_attention(self, q, k, v, *, causal=True, window=None,
                        prefix_len=0, q_offset=None, kv_valid_len=None):
        B, Lq, H, Dh = q.shape
        dv = {} if v.shape[-1] == Dh else {"Dv": v.shape[-1]}
        self.calls.append(("flash_attention", dict(
            B=B, Lq=Lq, Lkv=k.shape[1], H=H, Hkv=k.shape[2], Dh=Dh, **dv),
            _dtype_name(q.dtype), dict(causal=causal, window=window,
                                       prefix_len=prefix_len,
                                       q_offset=q_offset),
            None if kv_valid_len is None else kv_valid_len.clone()))
        return self._ops.flash_attention(
            q, k, v, causal=causal, window=window, prefix_len=prefix_len,
            q_offset=q_offset, kv_valid_len=kv_valid_len)

    def decode_attention(self, q, k_cache, v_cache, kv_len, *, k_scale=None,
                         v_scale=None):
        B, H, Dh = q.shape
        dv = {} if v_cache.shape[-1] == Dh else {"Dv": v_cache.shape[-1]}
        from repro_torch.kernels.decode_attention import kernel
        self.calls.append(("decode_attention", dict(
            B=B, H=H, Hkv=k_cache.shape[2], Dh=Dh, **dv), k_cache.shape[1],
            _dtype_name(q.dtype), k_scale is not None, kv_len.clone()))
        out = self._ops.decode_attention(q, k_cache, v_cache, kv_len,
                                         k_scale=k_scale, v_scale=v_scale)
        self.n_split.append(kernel.last_n_split.value)
        return out

    def wkv6(self, r, k, v, w, u, state):
        self.calls.append(("wkv6", tuple(r.shape), _dtype_name(r.dtype),
                           state.abs().amax()))
        return self._ops.wkv6(r, k, v, w, u, state)

    def distinct(self) -> set:
        """The distinct calls; a WKV6 call as (name, shape, dtype, whether
        its state was carried, i.e. not all 0)."""
        out = set()
        for c in self.calls:
            if c[0] == "flash_attention":
                _, shape, dt, kw, kvl = c
                out.add(("flash_attention", tuple(shape.items()), dt,
                         tuple(kw.items()),
                         None if kvl is None else tuple(kvl.tolist())))
            elif c[0] == "wkv6":
                _, shape, dt, st = c
                out.add(("wkv6", shape, dt, float(st) > 0))
            else:
                _, shape, Lc, dt, int8, kvl = c
                out.add(("decode_attention", tuple(shape.items()), Lc, dt,
                         int8, tuple(kvl.tolist())))
        return out


def phase_attention_main_shapes(torch, calls: set, seed: int) -> Agreement:
    """Every distinct K3/K4 call of the main path (served streams and
    engine-long), held against the plain version at its own shapes,
    dtypes, masks and kv lengths."""
    agree = Agreement()
    for i, c in enumerate(sorted(calls, key=repr)):
        if c[0] == "flash_attention":
            _, shape, dt, kw, kvl = c
            compare_flash(torch, agree, dict(shape), getattr(torch, dt),
                          seed + 1000 + i,
                          kv_valid_len=None if kvl is None else list(kvl),
                          **dict(kw))
        else:
            _, shape, Lc, dt, int8, kvl = c
            compare_decode(torch, agree, dict(shape), Lc, list(kvl),
                           getattr(torch, dt), int8, seed + 1000 + i)
    n_f = sum(c[0] == "flash_attention" for c in calls)
    log_agreement(f"distinct calls of the main path ({n_f} K4, "
                  f"{len(calls) - n_f} K3), each at its own arguments,",
                  agree)
    return agree


# ---------------------------------------------------------------------------
# phase 3: cache decisions across backends
# ---------------------------------------------------------------------------


class WindowRecorder:
    """Wraps one pallas_q8 cache's exact rescore and notes, at each lookup,
    how many of each query's top rescore_k quant candidates lie within
    2 eps of its best (DESIGN.md §15). A count of rescore_k means the margin
    window holds rescore_k rows or more, and then the whole lookup falls
    back to the dense reference. Host arithmetic on the candidates the
    rescore receives anyway, for the log."""

    def __init__(self, cache):
        import numpy as np
        from repro_torch.core.semantic_cache import QUANT_SLACK
        self.rescore_k = cache.rescore_k
        self.windows: list = []
        rescore = cache._rescore_exact

        def recording(queries, cand_s, cand_r, kth, err_max):
            eps = err_max * np.linalg.norm(queries.astype(np.float64),
                                           axis=1) + QUANT_SLACK
            m = np.max(np.where(np.isfinite(cand_s), cand_s, -np.inf),
                       axis=1, initial=-np.inf)
            self.windows.append(
                (cand_s >= (m - 2.0 * eps)[:, None]).sum(axis=1))
            return rescore(queries, cand_s, cand_r, kth, err_max)
        cache._rescore_exact = recording

    def full(self) -> int:
        """Lookups with at least one full window: the ones that fell back."""
        return sum(int((w >= self.rescore_k).any()) for w in self.windows)


def phase_cache(torch, np, seed: int) -> dict:
    """One stream through three backends. Odd steps send batches of exact
    and near copies only (the q8 margin windows are narrow, so K2's top-16
    plus the exact rescore decides them); even steps mix in random queries,
    whose windows at dim 768 often hold more than 16 rows and so fall back
    to the dense reference. Both q8 routes must equal dense bit for bit."""
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    A = 64

    def unit(rng, n):
        v = rng.normal(size=(n, D)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def store(vecs, sizes, aid0):
        st = CentroidStore(D, A)
        st.add(vecs, vecs[:, :A], sizes,
               answer_id=np.arange(len(vecs)) + aid0)
        return st

    def stream(backend):
        rng = np.random.default_rng(seed)
        cache = SemanticCache(D, A, capacity=20600, backend=backend,
                              device=DEV)
        rec = WindowRecorder(cache) if backend == "pallas_q8" else None
        base = unit(rng, 20000)
        cache.set_centroids(store(base, rng.uniform(1, 50, 20000).round(),
                                  0))
        parts, results, steps = [base], [], []
        for step in range(24):
            B = int(rng.integers(1, 33))
            q = unit(rng, B)
            pool = np.concatenate(parts)
            pick = rng.integers(0, len(pool), size=B)
            kind = rng.integers(step % 2, 3, size=B)    # 0 random, 1 copy,
            near = pool[pick] + 0.03 * unit(rng, B)     # 2 near copy
            near /= np.linalg.norm(near, axis=1, keepdims=True)
            q[kind == 1] = pool[pick][kind == 1]
            q[kind == 2] = near[kind == 2]
            theta = float(rng.choice([0.6, 0.95, 0.999, -1.0]))
            fb0 = cache.quant_fallbacks
            results.append(cache.lookup(q, theta, update_counts=theta > 0))
            steps.append((kind, cache.quant_fallbacks > fb0))
            for _ in range(int(rng.integers(0, 40))):
                v = unit(rng, 1)[0]
                cache.insert_spill(v, v[:A], answer_id=100000 + step)
                parts.append(v[None])
            if step == 12:
                new = unit(rng, 5000)
                st = store(new, np.arange(5000, 0, -1.0), 50000)
                cache.begin_shadow(len(st))
                for s in range(0, 5000, 1024):
                    cache.shadow_write(st.vectors[s:s + 1024],
                                       st.answers[s:s + 1024],
                                       st.answer_id[s:s + 1024])
                cache.commit_shadow(st)
                parts[0] = new      # the old centroid rows are gone
        return cache, results, steps, rec

    runs = {b: stream(b) for b in ("dense", "pallas", "pallas_q8")}
    dense = runs["dense"][1]
    for b in ("pallas", "pallas_q8"):
        for step, (r, d) in enumerate(zip(runs[b][1], dense)):
            for f in ("hit", "entry", "region", "answer_id", "generation"):
                check(np.array_equal(getattr(r, f), getattr(d, f)),
                      f"[cache] {b} step {step}: {f} differs from dense")
            if b == "pallas_q8":
                check(np.array_equal(r.sim, d.sim),
                      f"[cache] q8 step {step}: sims not bitwise dense")
            else:
                check(np.allclose(r.sim, d.sim, atol=ATOL, rtol=0),
                      f"[cache] pallas step {step}: sims differ")
    hits = int(sum(r.hit.sum() for r in dense))
    q8, steps, rec = (runs["pallas_q8"][0], runs["pallas_q8"][2],
                      runs["pallas_q8"][3])
    check(hits > 20, "[cache] stream served too few hits to mean anything")
    check(runs["pallas"][0].dev_swaps == 1, "[cache] no shadow commit")
    covered = sum(not fb for _, fb in steps)
    check(covered >= 10, f"[cache] only {covered} of {len(steps)} q8 "
                         f"lookups were decided by K2 + the exact rescore")
    check(len(rec.windows) == len(steps)
          and rec.full() == q8.quant_fallbacks,
          "[cache] margin windows do not account for the fallbacks")
    kinds = np.concatenate([k for k, _ in steps])
    wins = np.concatenate(rec.windows)
    win_by_kind = {}
    for kd, label in enumerate(("random", "copy", "near_copy")):
        w = wins[kinds == kd]
        win_by_kind[label] = {
            "queries": int(len(w)),
            "median": float(np.median(w)) if len(w) else None,
            "full": int((w >= q8.rescore_k).sum())}
    info = {"lookups": len(dense), "hits": hits,
            "q8_covered_lookups": covered,
            "quant_rescored": q8.quant_rescored,
            "quant_fallbacks": q8.quant_fallbacks,
            "err_max": q8._device_state().err_max,
            "margin_windows": win_by_kind,
            "dev_row_writes": q8.dev_row_writes}
    log(f"[cache] dense / pallas / pallas_q8 decisions identical over "
        f"{len(dense)} lookups ({hits} hits, 1 shadow commit); q8 sims "
        f"bitwise dense on both routes: {covered} lookups by K2 + exact "
        f"rescore (quant_rescored={q8.quant_rescored}), "
        f"{q8.quant_fallbacks} by the dense fallback")
    log(f"[cache] q8 margin windows (of the top {q8.rescore_k} candidates,"
        f" those within 2 eps of the best; err_max {info['err_max']:.5f}; a "
        f"full window forces the fallback): " + "; ".join(
            f"{k} n={v['queries']} median={v['median']} full={v['full']}"
            for k, v in win_by_kind.items()))
    return info


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------


def phase_engine_consistency(torch, np, seed: int, kv_dtype: str) -> None:
    """Small-input reference check of the engine on the card, through K4
    and K3, reduced qwen3 in fp32. With the f32 KV cache, batched per-slot
    KV-cached decode gives the tokens of greedy decoding by full re-prefill
    (no cache). With the int8 cache, whose codes change what decode attends
    to, it gives the tokens of one-sequence decoding with its own int8
    cache."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ModelEngine
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                    kv_dtype=kv_dtype)
    params = lm.init_params(gen(torch, seed),
                            cfg, device=DEV)
    eng = ModelEngine(params, cfg, n_slots=2, max_len=32, device=DEV)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9)]
    toks = np.asarray([eng.prefill_into(s, p) for s, p in enumerate(prompts)])
    outs = [[int(t)] for t in toks]
    for _ in range(6):
        toks = eng.decode_active(toks)
        for s in range(2):
            outs[s].append(int(toks[s]))
    with torch.inference_mode():
        for p, out in zip(prompts, outs):
            seq = list(p)
            cache = lm.init_cache(cfg, 1, 32, device=DEV)
            logits, _ = lm.prefill(params, cfg, {"tokens": torch.tensor(
                [seq], device=DEV)}, cache)
            for i, t in enumerate(out):
                ref_tok = int(torch.argmax(logits[0]))
                check(ref_tok == t, f"[serve] {kv_dtype} KV: cached batched "
                                    f"decode disagrees with the reference "
                                    f"at token {i}")
                seq.append(t)
                if kv_dtype == "int8":
                    logits, cache = lm.decode_step(
                        params, cfg, torch.tensor([[t]], device=DEV), cache,
                        len(seq) - 1)
                else:
                    logits, _ = lm.prefill(params, cfg, {
                        "tokens": torch.tensor([seq], device=DEV)},
                        lm.init_cache(cfg, 1, 32, device=DEV))
    ref = ("one-sequence int8-cached decode" if kv_dtype == "int8"
           else "re-prefill greedy decoding")
    log(f"[serve] engine, {kv_dtype} KV: batched KV-cached decode == {ref} "
        f"(reduced qwen3, fp32, through K4/K3 on the card)")


def build_models(torch, layers: int, seed: int):
    from repro_torch.configs.base import get_config
    from repro_torch.models import embedder as E, lm
    ecfg = get_config("siso-embedder").replace(dtype="float32")
    mcfg = get_config("qwen3-14b")
    if layers != mcfg.n_layers:
        log(f"[serve] depth cut: qwen3-14b at {layers} of "
            f"{mcfg.n_layers} layers (widths unchanged)")
        mcfg = mcfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    eparams = E.init_params(gen(torch, seed + 1), ecfg, device=DEV)
    mparams = lm.init_params(gen(torch, seed + 2), mcfg, device=DEV)
    torch.cuda.synchronize()
    n_m = lm.n_params(mparams)
    log(f"[serve] embedder {ecfg.name} d={ecfg.d_model} heads={ecfg.n_heads}"
        f" d_ff={ecfg.d_ff} vocab={ecfg.vocab_size} layers={ecfg.n_layers}"
        f" fp32; engine {mcfg.name} d={mcfg.d_model} heads={mcfg.n_heads}/"
        f"{mcfg.n_kv_heads} d_head={mcfg.head_dim} d_ff={mcfg.d_ff} vocab="
        f"{mcfg.vocab_size} layers={mcfg.n_layers} bf16: {n_m / 1e9:.2f}B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    return ecfg, eparams, mcfg, mparams


def served_requests(np, tok, mcfg, texts, base: int) -> list:
    """The gateway requests for ``texts`` (request ids from ``base``)."""
    from repro_torch.serving.gateway import GatewayRequest
    reqs = []
    for rid, text in enumerate(texts, start=base):
        ids, mask = tok.encode_batch([text])
        prompt = np.asarray(tok.tokenize(text)[:12], np.int64) \
            % mcfg.vocab_size
        reqs.append(GatewayRequest(rid=rid, model_tokens=prompt,
                                   embed_tokens=(ids[0], mask[0]),
                                   max_new=8))
    return reqs


def serve_once(torch, np, backend, models, recorder, att_recorders,
               seed: int, keep=None) -> dict:
    """One served stream; with ``keep`` (a dict), the SISO's state before
    the stream, the served SISO, its embed and answer functions, the
    stream and the stream's embeddings are left there for the shard
    phase."""
    from repro_torch.core import semantic_cache as SC
    from repro_torch.core.siso import SISO, SISOConfig
    from repro_torch.data.synth import SyntheticWorkload
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import embedder as E, layers as L
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import ServingGateway
    ecfg, eparams, mcfg, mparams = models
    tok = HashTokenizer(vocab_size=ecfg.vocab_size, max_len=24)
    embedded = []             # the stream's query embeddings, as served
    encode_ms: dict = {}      # batch size -> host ms of each E.encode

    def encode(ids, mask):
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = E.encode(eparams, ecfg, torch.tensor(ids, device=DEV),
                           torch.tensor(mask, device=DEV)).cpu().numpy()
        encode_ms.setdefault(len(ids), []).append(
            1e3 * (time.perf_counter() - t0))    # .cpu() synchronised
        return out

    def embed_tokens(batches):
        out = encode(np.stack([t[0] for t in batches]),
                     np.stack([t[1] for t in batches]))
        embedded.append(out)
        return out

    def answer_embed(out_tokens):
        ids, mask = tok.encode_batch([" ".join(f"t{t}" for t in out_tokens)])
        return encode(ids, mask)[0]

    # set-up: bootstrap SISO from a synthetic history at dim 768
    t0 = time.perf_counter()
    n_hist = N_HIST
    wl = SyntheticWorkload("quora", dim=ecfg.d_model, n_clusters=20000,
                           seed=seed)
    hist = wl.sample(n_hist, rps=100.0)
    siso = SISO(SISOConfig(dim=ecfg.d_model, answer_dim=ecfg.d_model,
                           capacity=n_hist + 4096, theta_r=0.95,
                           backend=backend, dynamic_threshold=False,
                           refresh_frac=8.0 / n_hist), device=DEV)
    siso.bootstrap(hist.vectors, hist.answers,
                   answer_ids=np.arange(n_hist) + 10**6)
    n_cent = len(siso.cache.centroids)
    check(n_cent >= MIN_CENTROIDS,
          f"[serve] centroid region {n_cent} < {MIN_CENTROIDS} rows")
    if keep is not None:      # the shard phase replays the stream from here
        keep["boot_state"] = copy.deepcopy(siso.state_dict())
    engine = ModelEngine(mparams, mcfg, n_slots=3, max_len=96, device=DEV)
    gw = ServingGateway(siso, engine, embed_fn=embed_tokens,
                        answer_fn=answer_embed)
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(40):
        topic = rng.choice(list(TOPICS))
        stream.append(str(rng.choice(TOPICS[topic])))
    setup_s = time.perf_counter() - t0
    # the main path: counters read only around the served stream
    name = "cosine_topk" if backend == "pallas" else "cosine_topk_q8"
    kern = getattr(ops, name)
    torch.cuda.synchronize()
    kern.launches = 0
    other = ops.cosine_topk_q8 if backend == "pallas" else ops.cosine_topk
    other.launches = 0
    zero_attention_launches()
    fallbacks0 = siso.cache.quant_fallbacks
    windows = WindowRecorder(siso.cache) if backend == "pallas_q8" else None
    SC.ctk_ops = recorder
    encode_ms.clear()
    t0 = time.perf_counter()
    with recorded_ops(L, att_recorders):
        for base in range(0, len(stream), 4):
            gw.submit(served_requests(np, tok, mcfg, stream[base:base + 4],
                                      base))
        done = gw.drain()
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    SC.ctk_ops = ops
    encode_p50 = {b: statistics.median(t) for b, t in encode_ms.items()}
    launches = kern.launches
    att = attention_launches()
    rep = gw.report()
    check(rep["completed"] == len(stream) == len(done),
          f"[serve] {rep['completed']} of {len(stream)} completed")
    check(rep["served_cache"] > 0, "[serve] nothing served from the cache")
    check(rep["served_engine"] > 0, "[serve] nothing served by the engine")
    check(launches > 0, f"[serve] {name} was never launched")
    check(att["flash_attention"] > 0 and att["flash_attention_f32"] > 0
          and att["decode_attention"] > 0,
          f"[serve] attention kernels not launched: {att}")
    for r in done:
        if r.served_by == "engine":
            check(len(r.out) == 8 and all(0 <= t < mcfg.vocab_size
                                          for t in r.out),
                  f"[serve] rid {r.rid}: bad completion {r.out}")
        check(r.answer is not None and np.isfinite(r.answer).all()
              and r.answer.shape == (ecfg.d_model,),
              f"[serve] rid {r.rid}: bad answer")
    lk = rep["lookup"]
    log(f"[serve] backend={backend}: {rep['completed']} requests, "
        f"{rep['served_cache']} from cache, {rep['served_engine']} through "
        f"the engine; hits={rep['hits']} misses={rep['misses']}; lookup "
        f"p50={lk['p50_ms']:.3f} ms p99={lk['p99_ms']:.3f} ms; "
        f"{name} launches={launches}; K4 launches="
        f"{att['flash_attention']} bf16 + {att['flash_attention_f32']} f32, "
        f"K3 launches={att['decode_attention']}; "
        f"centroids={n_cent}, mirror rows="
        f"{siso.cache._dev.pad if siso.cache._dev is not None else 0}; "
        f"refreshes={rep['refreshes']}; set-up {setup_s:.1f} s, "
        f"served in {serve_s:.1f} s; E.encode host ms (median) "
        + ", ".join(f"{encode_p50[b]:.3f} at B={b} ({len(encode_ms[b])} "
                    f"calls)" for b in sorted(encode_p50)))
    check(4 in encode_p50, "[serve] no batch of 4 was embedded")
    if keep is not None:
        keep.update(siso=siso, embed_fn=embed_tokens, answer_fn=answer_embed,
                    tok=tok, stream=stream,
                    queries=np.concatenate(embedded))
    extra = {}
    if backend == "pallas_q8":
        # what one margin-coverage fallback costs (the dense reference over
        # the host-resident f32 rows), timed on the served batch size
        qs = encode(*tok.encode_batch(stream[:4]))
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            siso.cache._dense_reference_lookup(qs)
            times.append(1e3 * (time.perf_counter() - t1))
        fell_back = siso.cache.quant_fallbacks - fallbacks0
        check(windows.full() == fell_back,
              "[serve] margin windows do not account for the fallbacks")
        wins = np.concatenate(windows.windows)
        extra = {"fallbacks_in_stream": fell_back,
                 "fallback_ms": statistics.median(times),
                 "lookup_sizes": [len(w) for w in windows.windows],
                 "lookup_max_windows": [int(w.max())
                                        for w in windows.windows],
                 "queries_with_full_window": int(
                     (wins >= siso.cache.rescore_k).sum())}
        log(f"[serve] quant_rescored={rep['quant_rescored']} "
            f"quant_fallbacks={rep['quant_fallbacks']}; {fell_back} of "
            f"{len(windows.windows)} lookups in the served stream fell back;"
            f" one fallback (dense reference, B=4) takes "
            f"{extra['fallback_ms']:.3f} ms host time; largest margin window"
            f" per lookup (B): " + ", ".join(
                f"{m} ({b})" for m, b in zip(extra["lookup_max_windows"],
                                             extra["lookup_sizes"]))
            + f"; {extra['queries_with_full_window']} of {len(wins)} "
            f"queries had a full window ({siso.cache.rescore_k})")
    return {"backend": backend, "kernel": name, "launches": launches,
            "attention_launches": att, "encode_ms_median": encode_p50,
            "other_kernel_launches": other.launches, **extra,
            "batches": len(stream) // 4, "served_s": serve_s,
            "setup_s": setup_s, "centroids": n_cent,
            "report": {k: v for k, v in rep.items()
                       if k not in ("theta_trace", "lam_trace")}}


# ---------------------------------------------------------------------------
# phase 5: engine-long, the served qwen3-14b on 4,096-token prompts
# ---------------------------------------------------------------------------

LONG_PROMPT, LONG_SLOTS, LONG_MAX, LONG_STEPS = 4096, 4, 8192, 16
# the served qwen3-14b's depth (``--layers``), phases 4-9: 20 of its 40
# layers since the script grew by a quarter (the dense kinds, five more
# trained kinds and phase 15); widths unchanged
SERVED_LAYERS = 20
ENGINE_RTOL = 0.05   # largest |kernel - plain| logit over the largest
                     # |plain| logit: bf16 activations through the layers of
                     # random weights round differently once an attention
                     # output moves by one bf16 ulp. Each K3/K4 call is
                     # also held against its plain version at its own
                     # arguments; this limit must fail a planted fault
                     # (one kv tile dropped from the last quarter of the
                     # prefill rows, every layer)


class swap_attention:
    """Within the block, ``models.layers`` runs its plain attention on CUDA
    tensors too (the reference the kernels are held against), or the given
    prefill (``flash``) or decode attention (``decode``) in place of K4 or
    K3 (a planted fault). Given ``S`` (``models.ssm``), its WKV6 recurrence
    likewise runs the plain step loop, or ``wkv`` (in
    ``kernels.wkv6.ops.wkv6``'s signature), in place of the kernel."""

    def __init__(self, L, flash=None, decode=None, S=None, wkv=None):
        from repro_torch.kernels.wkv6.ref import wkv6_ref
        self.L, self.S = L, S
        self.fns = (flash or L.flash_attention_plain,
                    decode or L.decode_attention_plain)
        self.wkv_ops = SimpleNamespace(wkv6=wkv or wkv6_ref)

    def __enter__(self):
        L = self.L
        self.saved = (L.flash_attention, L.decode_attention)
        L.flash_attention, L.decode_attention = self.fns
        if self.S is not None:
            self.saved_wkv, self.S.wkv6_ops = self.S.wkv6_ops, self.wkv_ops

    def __exit__(self, *exc):
        self.L.flash_attention, self.L.decode_attention = self.saved
        if self.S is not None:
            self.S.wkv6_ops = self.saved_wkv


class recorded_ops:
    """Within the block, ``models.layers`` reaches K4 and K3 through the
    first two OpsRecorders of ``recorders`` and, given ``S``
    (``models.ssm``), WKV6 through the third; each notes each call and
    passes it on."""

    def __init__(self, L, recorders, S=None):
        self.L, self.rec, self.S = L, recorders, S

    def __enter__(self):
        self.saved = (self.L.fa_ops, self.L.da_ops)
        self.L.fa_ops, self.L.da_ops = self.rec[:2]
        if self.S is not None:
            self.saved_wkv, self.S.wkv6_ops = self.S.wkv6_ops, self.rec[2]

    def __exit__(self, *exc):
        self.L.fa_ops, self.L.da_ops = self.saved
        if self.S is not None:
            self.S.wkv6_ops = self.saved_wkv


def trace_decode(torch, eng, toks, steps: int = 2) -> dict:
    """``steps`` decode steps under torch.profiler: the device's busy time
    per step (the union of the kernel and copy intervals the profiler
    records on the card) and the kernels that took the most of it. Empty
    where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            toks = eng.decode_active(toks)
        torch.cuda.synchronize()
    tr = device_summary(prof, steps)
    if not tr:
        return {}
    k3 = sum(t for n, t in tr["by_name_ms"].items() if "da::decode" in n)
    return {"steps": steps, "device_events": tr["device_events"],
            "busy_ms_per_step": tr["busy_ms"], "k3_ms_per_step": k3,
            "k3_share_of_busy": k3 / tr["busy_ms"],
            "top_kernels_ms_per_step": tr["top_kernels_ms"]}


def device_summary(prof, n: int) -> dict:
    """Per one of ``n`` repeats: the device's busy ms (the union of the
    kernel and copy intervals the profiler recorded on the card), ms by
    kernel name and the largest kernels. Empty without device events."""
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if str(e.device_type).endswith("CUDA")
                 # a range's device-side copy is a span, gaps included
                 and not getattr(e, "is_user_annotation", False))
    if not dev:
        return {}
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in dev:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_events": len(dev), "busy_ms": busy / 1e3 / n,
            "by_name_ms": by_name,
            "top_kernels_ms": [(k[:120], t) for k, t in top]}


def trace_prefill(torch, eng, prompt) -> dict:
    """One prefill of ``prompt`` into slot 0 under torch.profiler: the
    device's busy ms, K4's ms (the ``flash_bf16`` launches) and its share
    of the busy time, and the largest kernels. Empty where the profiler
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.prefill_into(0, prompt)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    tr = device_summary(prof, 1)
    if not tr:
        return {}
    k4 = sum(t for k, t in tr.pop("by_name_ms").items() if "flash_bf16" in k)
    return {"profiled_wall_ms": wall, "k4_ms": k4,
            "k4_share_of_busy": k4 / tr["busy_ms"], **tr}


def rel_diff(torch, a, b) -> float:
    a, b = a.float(), b.float()
    check(bool(torch.isfinite(a).all()), "[engine-long] non-finite logits")
    return float((a - b).abs().max() / b.abs().max())


def attention_launches():
    """K4's launches by dtype (the bf16 prefill; the f32 embedder and
    engine check) and in the Dv mode (MLA's prefill), and K3's by cache
    and in the Dv mode (MLA's materialised decode): the launcher's
    ``kernel_launches`` without K1/K2."""
    from repro_torch.launch.serve import kernel_launches
    return {k: v for k, v in kernel_launches().items() if k in ATT_KEYS}


def zero_attention_launches() -> None:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    fa.flash_attention.launches = fa.flash_attention.launches_f32 = 0
    da.decode_attention.launches = da.decode_attention.launches_int8 = 0
    fa.flash_attention.launches_dv = da.decode_attention.launches_dv = 0
    fa.flash_attention.launches_persistent = 0


def phase_engine_long(torch, np, models, att_recorders, seed: int,
                      kv_dtype: str) -> dict:
    """Four 4,096-token prompts prefilled into a 4-slot engine (K4 on every
    layer), then 16 batched decode steps (K3 on every layer). The launch
    counters are zeroed before the prefills and before the decode steps and
    read after each, and the OpsRecorders note every K3/K4 call of those
    windows; the comparisons with the plain layers run outside them. The
    first prefill's last-position logits and the first decode step's
    logits are held against the plain layers at ENGINE_RTOL; with the bf16
    cache, a planted fault must exceed it. The comparison's decode step
    writes the new k/v at each slot's position, which the engine's own
    first step then overwrites with the same computation, so the engine's
    state is unchanged by it. Two more decode steps then run under the
    profiler (``trace_decode``): the device's busy time and idle share."""
    from repro_torch.models import layers as L, lm
    from repro_torch.serving.engine import ModelEngine
    mparams, mcfg = models[3], models[2]
    cfg = mcfg.replace(kv_dtype=kv_dtype)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(0, cfg.vocab_size, LONG_PROMPT)
               for _ in range(LONG_SLOTS)]
    first = {"tokens": torch.tensor(prompts[0][None], device=DEV)}
    with torch.inference_mode():
        kl, _ = lm.prefill(mparams, cfg, first, lm.init_cache(
            cfg, 1, LONG_PROMPT, device=DEV))
        with swap_attention(L):
            pl, _ = lm.prefill(mparams, cfg, first, lm.init_cache(
                cfg, 1, LONG_PROMPT, device=DEV))
        rel_fault = None
        if kv_dtype == "bfloat16":
            def faulty(q, k, v, **kw):
                check(kw == {"causal": True, "window": None,
                             "prefix_len": 0},
                      f"[engine-long] prefill attention called with {kw}")
                return flash_tile_dropped(torch, q, k, v)
            with swap_attention(L, flash=faulty):
                fl, _ = lm.prefill(mparams, cfg, first, lm.init_cache(
                    cfg, 1, LONG_PROMPT, device=DEV))
            rel_fault = rel_diff(torch, fl, pl)
            check(rel_fault > ENGINE_RTOL,
                  f"[engine-long] a planted attention fault moves the logits"
                  f" by {rel_fault:.4g} of the largest, within ENGINE_RTOL "
                  f"{ENGINE_RTOL}: the limit cannot see it")
            log(f"[engine-long] planted fault (one kv tile dropped from the "
                f"last quarter of the prefill rows, every layer): logits "
                f"move by {rel_fault:.4g} of the largest (limit "
                f"{ENGINE_RTOL})")
            del fl
    rel_prefill = rel_diff(torch, kl, pl)
    del kl, pl
    torch.cuda.empty_cache()
    eng = ModelEngine(mparams, cfg, n_slots=LONG_SLOTS, max_len=LONG_MAX,
                      device=DEV)
    torch.cuda.synchronize()
    zero_attention_launches()
    prefill_ms, toks = [], []
    with recorded_ops(L, att_recorders):
        for s, p in enumerate(prompts):
            t0 = time.perf_counter()
            toks.append(eng.prefill_into(s, p))
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
    launches = attention_launches()
    toks = np.asarray(toks, np.int64)
    with torch.inference_mode():
        pos = torch.tensor(eng.pos.astype(np.int64), device=DEV)
        tok = torch.tensor(toks, device=DEV)[:, None]
        kd, _ = lm.decode_step(mparams, cfg, tok, eng.cache, pos,
                               kv_len=pos + 1)
        with swap_attention(L):
            pd, _ = lm.decode_step(mparams, cfg, tok, eng.cache, pos,
                                   kv_len=pos + 1)
    rel_decode = rel_diff(torch, kd, pd)
    torch.cuda.synchronize()
    zero_attention_launches()
    decode_ms = []
    with recorded_ops(L, att_recorders):
        for _ in range(LONG_STEPS):
            t0 = time.perf_counter()
            toks = eng.decode_active(toks)
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    for k, v in attention_launches().items():
        launches[k] += v
    n = cfg.n_layers
    k3 = "decode_attention_int8" if kv_dtype == "int8" else "decode_attention"
    check(launches["flash_attention"] == LONG_SLOTS * n
          and launches[k3] == LONG_STEPS * n,
          f"[engine-long] {kv_dtype}: launches {launches}, expected "
          f"{LONG_SLOTS * n} K4 and {LONG_STEPS * n} {k3}")
    check(all(0 <= t < cfg.vocab_size for t in toks),
          f"[engine-long] {kv_dtype}: bad tokens {toks}")
    check(rel_prefill <= ENGINE_RTOL and rel_decode <= ENGINE_RTOL,
          f"[engine-long] {kv_dtype}: kernel vs plain logits differ by "
          f"{rel_prefill:.4g} (prefill) / {rel_decode:.4g} (decode) of the "
          f"largest logit, over {ENGINE_RTOL}")
    kv_bytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    rec = {"kv_dtype": kv_dtype, "prefill_ms": prefill_ms,
           "decode_ms": decode_ms,
           "prefill_ms_median": statistics.median(prefill_ms),
           "decode_ms_median": statistics.median(decode_ms),
           "rel_diff_prefill": rel_prefill, "rel_diff_decode": rel_decode,
           "rel_diff_planted_fault": rel_fault, "launches": launches, "kv_cache_bytes": kv_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"[engine-long] {kv_dtype} KV ({kv_bytes / 2**30:.2f} GiB cache): "
        f"{LONG_SLOTS} prompts of {LONG_PROMPT} tokens, prefill "
        f"{rec['prefill_ms_median']:.1f} ms per prompt (median; "
        f"{', '.join(f'{t:.1f}' for t in prefill_ms)}), {LONG_STEPS} decode "
        f"steps {rec['decode_ms_median']:.2f} ms per step (median); kernel vs "
        f"plain logits: largest difference {rel_prefill:.4g} (prefill) and "
        f"{rel_decode:.4g} (decode) of the largest logit (tolerance "
        f"{ENGINE_RTOL}); launches {launches}; peak memory "
        f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")
    rec["trace"] = tr = trace_decode(torch, eng, toks)
    if not tr:
        log(f"[engine-long] {kv_dtype} KV: the profiler recorded no device "
            f"activity; device busy time not measured")
    else:
        busy = tr["busy_ms_per_step"]
        log(f"[engine-long] {kv_dtype} KV, profiled decode: device busy "
            f"{busy:.3f} ms per step ({tr['device_events']} device events "
            f"over {tr['steps']} steps), K3 {tr['k3_ms_per_step']:.3f} ms "
            f"of it ({tr['k3_share_of_busy']:.3f}), idle share "
            f"{1 - busy / rec['decode_ms_median']:.3f} of the unprofiled "
            f"median step; most device time: " + "; ".join(
                f"{n} {t:.3f} ms" for n, t in tr["top_kernels_ms_per_step"]))
    rec["prefill_trace"] = pt = trace_prefill(torch, eng, prompts[0])
    if not pt:
        log(f"[engine-long] {kv_dtype} KV: the profiler recorded no device "
            f"activity in a prefill; its split is not measured")
    else:
        log(f"[engine-long] {kv_dtype} KV, profiled prefill of "
            f"{LONG_PROMPT} tokens: device busy {pt['busy_ms']:.3f} ms "
            f"({pt['device_events']} device events, "
            f"{pt['profiled_wall_ms']:.1f} ms on the host clock); K4 {pt['k4_ms']:.3f} ms, "
            f"{pt['k4_share_of_busy']:.3f} of the busy time; most device "
            f"time: " + "; ".join(f"{n} {t:.3f} ms"
                                  for n, t in pt["top_kernels_ms"]))
    del eng
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 6: slo, the paper's four-system comparison and the live gateway
# ---------------------------------------------------------------------------

# (a) benchmarks/fig9_slo.py's configuration at the embedder's width
SIM_DIM, SIM_CLUSTERS, SIM_SEED = 768, 400, 9
SIM_TRAIN, SIM_TEST, SIM_CAPACITY, SIM_THETA = 8000, 800, 512, 0.86
SIM_STREAMS = ((10.0, 0.1), (8.0, 5.0))    # (rps, cv) of each test stream
SIM_RUNS = (("vllm", "vllm", None), ("gptcache", "gptcache", None),
            ("siso-nodta", "siso-nodta", "pallas"), ("siso", "siso", "pallas"),
            ("siso/dense", "siso", "dense"),
            ("siso/pallas_q8", "siso", "pallas_q8"))   # (key, kind, backend)
# (b) benchmarks/bench_slo.py's settings at the embedder's width
SLO_SLOTS, SLO_MAX_NEW, SLO_TICK_S, SLO_LAMBDA_WINDOW = 2, 6, 0.05, 2.0
SLO_CAPACITY, SLO_CLUSTERS, SLO_THETA = 160, 240, 0.86
SLO_TRAIN = 1200
SLO_TEST = 48       # bench_slo's 160, cut to keep the script near 240 s: a
                    # live request costs about 0.2 s of host time a system
SLO_S = 1.3 * SLO_MAX_NEW * SLO_TICK_S     # the paper's 1.3x zero-load rule
SLO_SCENARIOS = ("repeat_heavy", "topic_drift")
SLO_SYSTEMS = ("siso", "vectorcache", "nocache")


def topk_launches() -> dict:
    from repro_torch.kernels.cosine_topk import ops
    return {"cosine_topk": ops.cosine_topk.launches,
            "cosine_top1_local": ops.cosine_top1_local.launches,
            "cosine_topk_q8": ops.cosine_topk_q8.launches}


def zero_topk_launches() -> None:
    from repro_torch.kernels.cosine_topk import ops
    ops.cosine_topk.launches = ops.cosine_top1_local.launches = \
        ops.cosine_topk_q8.launches = 0


def paraphrase_cosine(np, batch, theta: float) -> dict:
    """What a fixed theta can hit: cosine of the paraphrase pairs (same
    cluster) among a stream's first 2,000 queries."""
    v, c = batch.vectors[:2000], batch.cluster_ids[:2000]
    iu = np.triu_indices(len(v), 1)
    dup = (v @ v.T)[iu][(c[:, None] == c[None, :])[iu]]
    return {"pairs": int(len(dup)), "median": float(np.median(dup)),
            "p90": float(np.percentile(dup, 90)),
            "share_ge_theta": float((dup >= theta).mean())}


def phase_slo_simulator(torch, np) -> dict:
    """The paper's comparison (vLLM, GPTCache, SISO-NoDTA, SISO) through
    the discrete-event ServingSimulator over the analytic engine (qwen3-14b
    on one H100, concurrency 4), SISO on backend pallas (K1), then SISO
    again on dense and on pallas_q8 (K2 + exact rescore): the three
    backends must give equal SimResults. K1/K2 launch counters are zeroed
    after each bootstrap and read after the run's two test streams."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.data.synth import SyntheticWorkload
    from repro_torch.serving.engine import AnalyticEngine, EngineModel
    from repro_torch.serving.simulator import (ServingSimulator,
                                               bootstrap_frontend,
                                               build_system)
    wl = SyntheticWorkload("quora", dim=SIM_DIM, n_clusters=SIM_CLUSTERS,
                           seed=SIM_SEED)
    train = wl.sample(SIM_TRAIN, rps=100)
    tests = [wl.sample(SIM_TEST, rps=rps, cv=cv) for rps, cv in SIM_STREAMS]
    model = EngineModel.from_config(get_config("qwen3-14b"), n_chips=1)
    L = model.e2e(float(np.mean(train.tokens_in)),
                  float(np.mean(train.tokens_out)))
    # the same workload at the reference bench's dim 32, for comparison
    dup_stats = {dim: paraphrase_cosine(np, b, SIM_THETA) for dim, b in (
        (SIM_DIM, train), (32, SyntheticWorkload(
            "quora", dim=32, n_clusters=SIM_CLUSTERS,
            seed=SIM_SEED).sample(2000, rps=100)))}
    for dim, st in dup_stats.items():
        log(f"[slo] sim workload at dim {dim}: {st['pairs']} paraphrase "
            f"pairs, cosine median {st['median']:.4f}, p90 {st['p90']:.4f}, "
            f"{st['share_ge_theta']:.4f} of them >= theta {SIM_THETA}")
    out, launches = {}, {"cosine_topk": 0, "cosine_topk_q8": 0}
    for key, kind, backend in SIM_RUNS:
        t0 = time.perf_counter()
        fe = build_system(kind, dim=SIM_DIM, capacity=SIM_CAPACITY,
                          theta_r=SIM_THETA, slo_latency=1.3 * L,
                          llm_latency=L, backend=backend or "dense",
                          device=DEV)
        bootstrap_frontend(fe, train)
        sim = ServingSimulator(AnalyticEngine(model, concurrency=4), fe)
        setup_s = time.perf_counter() - t0
        if backend is not None:
            st = fe.cache.centroids
            log(f"[slo] sim {key}: bootstrap kept {len(st)} centroids "
                f"(clustering at theta_C {fe.cfg.theta_c}), largest "
                f"cluster {int(st.cluster_size.max())}, "
                f"{int((st.cluster_size > 1).sum())} of more than one query")
        torch.cuda.synchronize()
        zero_topk_launches()
        t0 = time.perf_counter()
        res = [sim.run(t, name=kind) for t in tests]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = topk_launches()
        siso = backend is not None
        for fn, used in (("cosine_topk", backend == "pallas"),
                         ("cosine_topk_q8", backend == "pallas_q8")):
            check(n[fn] > 0 if used else n[fn] == 0,
                  f"[slo] {key}: {fn} launched {n[fn]} times")
            launches[fn] += n[fn]
        for r in res:
            vals = [r.hit_ratio, r.slo_attainment, r.mean_e2e, r.p99_e2e,
                    r.mean_wait, r.mean_quality, r.slo_weighted_quality]
            check(r.n == SIM_TEST and all(np.isfinite(vals))
                  and 0 <= r.hit_ratio <= 1 and 0 <= r.slo_attainment <= 1,
                  f"[slo] {key}: bad SimResult {r}")
            check(len(r.theta_trace) == (SIM_TEST if siso else 0),
                  f"[slo] {key}: theta trace length")
        out[key] = {"backend": backend, "wall_s": wall, "setup_s": setup_s,
                    "launches": n, "results": [dataclasses.asdict(r)
                                               for r in res]}
        for (rps, cv), r in zip(SIM_STREAMS, res):
            th = r.theta_trace or [float("nan")]
            log(f"[slo] sim {key:14s} rps={rps:g} cv={cv:g}: "
                f"hit={r.hit_ratio:.4f} slo={r.slo_attainment:.4f} "
                f"mean_e2e={r.mean_e2e:.4f} s p99={r.p99_e2e:.4f} s "
                f"quality={r.mean_quality:.4f} slo_quality="
                f"{r.slo_weighted_quality:.4f} theta=[{min(th):.2f},"
                f"{max(th):.2f}]")
        log(f"[slo] sim {key}: set-up {setup_s:.1f} s, two "
            f"streams in {wall:.1f} s; launches {n}")
    ref = out["siso"]["results"]
    for other in ("siso/dense", "siso/pallas_q8"):
        for i, (a, b) in enumerate(zip(ref, out[other]["results"])):
            for field, val in a.items():
                check(b[field] == val, f"[slo] stream {i}: siso on "
                                       f"{other.split('/')[1]} differs from "
                                       f"pallas in {field}")
    log(f"[slo] sim: siso on dense, pallas (K1) and pallas_q8 (K2 + exact "
        f"rescore) give equal SimResults on both streams (every field, "
        f"theta traces element for element); zero-load e2e L = {L:.4f} s "
        f"(qwen3-14b on one H100, analytic), SLO 1.3 L")
    return {"runs": out, "launches": launches, "zero_load_s": L,
            "paraphrase_cosine": dup_stats}


class VirtualClock:
    """Callable clock the gateway/scheduler read; the drive loop owns t."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def slo_drive(gw, clock, batch, vocab: int, seed: int = 0, chunk: int = 8,
              lo: int = 0, hi=None, max_ticks: int = 200_000) -> list:
    """benchmarks/bench_slo.py's discrete-event drive loop over requests
    [lo, hi): submit arrivals as they come due, one engine tick per
    SLO_TICK_S of virtual time (gw.submit's internal tick is billed too),
    jump idle gaps. Returns each submitted batch's hit mask."""
    import numpy as np
    from repro_torch.serving.gateway import GatewayRequest
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(len(batch.vectors), 6)).astype(
        np.int32)
    n = len(batch.vectors) if hi is None else hi
    i, hits = lo, []
    for _ in range(max_ticks):
        if i >= n and not gw.sched.queue and not gw.sched.active:
            return hits
        due = []
        while i < n and batch.arrivals[i] <= clock.t:
            due.append(GatewayRequest(
                rid=i, model_tokens=toks[i], embed_tokens=batch.vectors[i],
                user_id=int(batch.user_ids[i]), max_new=SLO_MAX_NEW,
                answer_vec=batch.answers[i]))
            i += 1
        if due:
            for j in range(0, len(due), chunk):
                hits.append(gw.submit(due[j: j + chunk], now=clock.t).copy())
                clock.t += SLO_TICK_S          # submit ran one engine tick
        else:
            gw.step()
            clock.t += SLO_TICK_S
        if (not gw.sched.active and not gw.sched.queue and i < n
                and batch.arrivals[i] > clock.t):
            clock.t = float(batch.arrivals[i])
    raise PhaseError("[slo] drive loop exceeded max_ticks")


def phase_slo_gateway(torch, np, models, recorder, att_recorders,
                      seed: int) -> dict:
    """The live SLO harness: each scenario's stream through the real
    ServingGateway over qwen3-14b (the served weights) under a virtual
    clock, for SISO (ServingGateway.from_config, backend pallas),
    VectorCache and NoCache. Launch counters are zeroed after each
    bootstrap and read after the drive; the recorders note every K1, K3
    and K4 call for the re-checks at their own arguments."""
    from repro_torch.core import semantic_cache as SC
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import layers as L
    from repro_torch.serving import CacheFrontend
    from repro_torch.serving.baselines import NoCache, VectorCache
    from repro_torch.serving.config import (CacheConfig, RefreshConfig,
                                            ServingConfig)
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import ServingGateway
    from repro_torch.serving.simulator import bootstrap_frontend
    from repro_torch.serving.workloads import build_scenario
    mcfg, mparams = models[2], models[3]
    dim = SIM_DIM
    engine = ModelEngine(mparams, mcfg, n_slots=SLO_SLOTS, max_len=48,
                         device=DEV)
    out = {}
    launches = {"cosine_topk": 0, **{k: 0 for k in ATT_KEYS}}
    for name in SLO_SCENARIOS:
        scn = build_scenario(name, dim=dim, n_clusters=SLO_CLUSTERS,
                             seed=seed, n_train=SLO_TRAIN, n_test=SLO_TEST)
        out[name] = {"notes": scn.notes}
        for kind in SLO_SYSTEMS:
            clock = VirtualClock()
            embed = lambda vs: np.stack(vs)      # noqa: E731 pre-embedded
            if kind == "siso":
                # refresh_async=False and a deliberately wrong llm_latency,
                # as bench_slo: the live EMA must calibrate it
                cfg = ServingConfig(
                    cache=CacheConfig(dim=dim, answer_dim=dim,
                                      capacity=SLO_CAPACITY,
                                      theta_r=SLO_THETA, backend="pallas",
                                      dynamic_threshold=True),
                    refresh=RefreshConfig(async_pipeline=False),
                    slo_latency=SLO_S,
                    llm_latency=0.2 * SLO_MAX_NEW * SLO_TICK_S)
                gw = ServingGateway.from_config(cfg, engine=engine,
                                                embed_fn=embed, clock=clock)
                gw.frontend.threshold.lambda_window = SLO_LAMBDA_WINDOW
                check(gw.frontend.device == engine.device,
                      "[slo] the gateway's frontend is not on the engine's "
                      "device")
            else:
                fe = (NoCache() if kind == "nocache" else
                      VectorCache(dim, dim, SLO_CAPACITY, policy="lru",
                                  theta_r=SLO_THETA))
                gw = ServingGateway(fe, engine, embed_fn=embed, clock=clock,
                                    slo_latency=SLO_S)
            check(isinstance(gw.frontend, CacheFrontend),
                  f"[slo] {kind} is not a CacheFrontend")
            bootstrap_frontend(gw.frontend, scn.train)
            torch.cuda.synchronize()
            zero_topk_launches()
            zero_attention_launches()
            SC.ctk_ops = recorder
            t0 = time.perf_counter()
            try:
                with recorded_ops(L, att_recorders):
                    slo_drive(gw, clock, scn.test, mcfg.vocab_size,
                              seed=seed + 1)
                    torch.cuda.synchronize()
            finally:
                SC.ctk_ops = ops
            wall = time.perf_counter() - t0
            n = {**topk_launches(), **attention_launches()}
            rep = gw.report()
            check(rep["completed"] == SLO_TEST == len(gw.done)
                  and sorted(r.rid for r in gw.done) == list(range(SLO_TEST)),
                  f"[slo] {name}/{kind}: {rep['completed']} of {SLO_TEST} "
                  f"completed")
            for r in gw.done:
                if r.served_by == "engine":
                    check(len(r.out) == SLO_MAX_NEW and all(
                        0 <= t < mcfg.vocab_size for t in r.out),
                        f"[slo] {name}/{kind} rid {r.rid}: bad completion")
                check(r.answer is not None and r.answer.shape == (dim,)
                      and bool(np.isfinite(r.answer).all()),
                      f"[slo] {name}/{kind} rid {r.rid}: bad answer")
            check(n["cosine_topk_q8"] == 0 and n["flash_attention_f32"] == 0,
                  f"[slo] {name}/{kind}: unexpected launches {n}")
            if kind == "siso":
                check(rep["served_cache"] > 0 and rep["served_engine"] > 0,
                      f"[slo] {name}/siso: served {rep['served_cache']} from "
                      f"the cache, {rep['served_engine']} by the engine")
                check(n["cosine_topk"] > 0, f"[slo] {name}/siso: K1 was "
                                            f"never launched")
            else:
                check(n["cosine_topk"] == 0, f"[slo] {name}/{kind}: K1 ran")
            if rep["served_engine"]:
                check(n["flash_attention"] > 0 and n["decode_attention"] > 0,
                      f"[slo] {name}/{kind}: attention kernels not "
                      f"launched: {n}")
            for k in launches:
                launches[k] += n[k]
            th = [p[1] for p in rep.get("theta_trace", [])] or [float("nan")]
            row = {"hit_ratio": rep.get("hit_ratio", 0.0),
                   "slo_attainment": rep.get("slo_attainment"),
                   "served_cache": rep["served_cache"],
                   "served_engine": rep["served_engine"],
                   "mean_wait": rep.get("mean_wait"),
                   "theta_min": min(th), "theta_max": max(th),
                   "refreshes": rep["refreshes"], "wall_s": wall,
                   "virtual_s": clock.t, "launches": n,
                   "lookup": rep["lookup"]}
            out[name][kind] = row
            log(f"[slo] live {name:12s} {kind:11s}: hit="
                f"{row['hit_ratio']:.4f} slo={row['slo_attainment']:.4f} "
                f"cache/engine={row['served_cache']}/{row['served_engine']}"
                f" theta=[{row['theta_min']:.2f},{row['theta_max']:.2f}] "
                f"refreshes={row['refreshes']} lookup p50="
                f"{row['lookup']['p50_ms']:.3f} ms; {wall:.1f} s wall for "
                f"{clock.t:.2f} s virtual; launches {n}")
    del engine
    torch.cuda.empty_cache()
    return {"scenarios": out, "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: planes — persistence, the device -> host -> disk tiers, tenants
# ---------------------------------------------------------------------------

# (a) the kill drill's SISO at the served width: a device tier of 8,320
# rows (8,192 centroid rows + a 128-row spill), a host tier kept below the
# host HNSW's switch-over (brute force: the port's HNSW build of 4,096 rows
# at dim 768 is a host cost this drill does not need), a disk tier in a
# temporary directory, and four tenants besides anonymous traffic
PLANES_HIST, PLANES_CAPACITY, PLANES_RESERVE = 9000, 8320, 128
PLANES_HOST, PLANES_DISK, PLANES_HNSW_MIN = 512, 16384, 4096
PLANES_TENANTS, PLANES_BATCH = 4, 8
PLANES_A, PLANES_B, PLANES_Q8_A, PLANES_Q8_B = 64, 24, 32, 16   # batches
PLANES_JITTER = 0.005   # per component at dim 768: a revisit's sim ~0.99,
                        # clear of every theta on the 0.60-0.98 grid; a
                        # fresh query's best sim stays near 0.15
PLANES_CHILD_S = 300.0  # the killed child's time limit
# (b) bench_restart's drill at dim 768 over the served qwen3-14b, with
# slo (b)'s virtual clock; a training set of 160 makes a refresh due
# after 16 misses, so phase A commits at least one refresh
RESTART_TRAIN, RESTART_A, RESTART_B = 160, 40, 32
# (c) bench_tiered / bench_tenancy at their smoke sizes, dim 768: every
# per-component noise (and the tier universe's question spread) scaled by
# sqrt(32 / 768), so a revisit's similarity is the benches' own
DRILL_SCALE = (32.0 / 768.0) ** 0.5


def planes_data(np, seed: int) -> dict:
    """The kill drill's seeded history and multi-tenant stream: revisits
    of history rows (some of which the bootstrap demoted to host/disk),
    re-asks of the same user's own recent query (repeat escapes, then
    personal answers in the tenant's overlay) and fresh queries."""
    rng = np.random.default_rng(seed + 70)
    d = SIM_DIM

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    hist = unit(rng.normal(size=(PLANES_HIST, d)))
    answers = unit(rng.normal(size=(PLANES_HIST, d)))
    n = (PLANES_A + PLANES_B) * PLANES_BATCH
    vecs = np.empty((n, d), np.float32)
    tenants = rng.integers(-1, PLANES_TENANTS, size=n)
    recent: dict = {}
    for i in range(n):
        u = rng.random()
        own = recent.get(int(tenants[i]))
        if own is not None and u < 0.2:
            base = own
        elif u < 0.65:
            base = hist[rng.integers(PLANES_HIST)]
        else:
            base = unit(rng.normal(size=d))
        vecs[i] = unit(base + PLANES_JITTER * rng.normal(size=d))
        recent[int(tenants[i])] = vecs[i]
    return {"hist": hist, "answers": answers, "vecs": vecs,
            "tenants": tenants.astype(np.int64),
            "users": (100 + tenants).astype(np.int64),
            "ans": unit(rng.normal(size=(n, d)))}


def planes_siso(np, data, disk_dir, backend: str = "pallas",
                planes: bool = True):
    """The drill's SISO on the card; bootstrapped from the history unless
    ``data`` is None (a fresh process image that a restore fills)."""
    from repro_torch.core.siso import SISO, SISOConfig
    from repro_torch.core.tenancy import TenancyConfig
    from repro_torch.core.tiered import TieredCacheConfig
    tiered = TieredCacheConfig(
        host_capacity=PLANES_HOST, disk_capacity=PLANES_DISK,
        disk_dir=disk_dir, device_reserve=PLANES_RESERVE,
        hnsw_min=PLANES_HNSW_MIN) if planes else None
    cfg = SISOConfig(dim=SIM_DIM, answer_dim=SIM_DIM,
                     capacity=PLANES_CAPACITY, theta_r=0.86,
                     backend=backend, refresh_async=False,
                     tiered=tiered,
                     tenancy=TenancyConfig() if planes else None)
    siso = SISO(cfg, device=DEV)
    if data is not None:
        siso.bootstrap(data["hist"], data["answers"],
                       answer_ids=np.arange(PLANES_HIST))
    return siso


def planes_drive(np, siso, data, lo: int, hi: int,
                 tenants: bool = True) -> list:
    """Batches [lo, hi) of the stream; misses record their answers back
    (under their tenant); one refresh_tick (promotions) a batch."""
    out = []
    B = PLANES_BATCH
    for b in range(lo, hi):
        s = slice(b * B, (b + 1) * B)
        q, tid = data["vecs"][s], data["tenants"][s]
        kw = {"tenant_ids": tid} if tenants else {}
        res = siso.handle_batch(q.copy(), now=0.5 * b,
                                user_ids=data["users"][s], **kw)
        out.append({f: np.array(getattr(res, f)) for f in
                    ("hit", "sim", "entry", "region", "answer_id")}
                   | {"generation": res.generation})
        for j in np.flatnonzero(~res.hit):
            i = b * B + j
            t = int(tid[j]) if tenants else -1
            siso.record_llm_answer(q[j], data["ans"][i],
                                   answer_id=10**6 + i,
                                   tenant=t if t >= 0 else None)
        siso.observe_completion(0.3, 0.2)
        siso.refresh_tick(0.0)
    return out


def planes_view(siso) -> dict:
    """What the restore must reproduce: tier membership and stats (the
    disk's segment count aside: a snapshot flushes the pending buffer),
    tenant state, serving counters and the hierarchy clock."""
    c = siso.cache
    st = c.tier_stats()
    st.pop("disk_segments")
    return {"membership": c.tier_membership(), "tier_stats": st,
            "tenants": siso.tenant_stats(),
            "registry": list(siso.registry._map.items()),
            "overlays": {t: ts.overlay.answer_id.copy()
                         for t, ts in siso._tenants.items()},
            "counts": (c.hits, c.misses, c.device.hits, c.device.misses),
            "clock": c.clock, "generation": c.generation}


def same(np, a, b) -> bool:
    """Exact equality of nested observations (sims included: one process,
    one kernel, the same mirror)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            same(np, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(np, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def planes_child(torch, np, out_dir: str, seed: int) -> None:
    """The killed process: serve phase A on the tiered multi-tenant SISO
    and on a plain pallas_q8 SISO, save both through the CheckpointManager
    (with the q8 mirror's live codes and scales beside the snapshot), note
    its kernel calls, then SIGKILL itself."""
    import os
    import signal
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import semantic_cache as SC
    from repro_torch.kernels.cosine_topk import ops
    recorder = CallRecorder(ops)
    SC.ctk_ops = recorder
    zero_topk_launches()
    data = planes_data(np, seed)
    s = planes_siso(np, data, os.path.join(out_dir, "cold"))
    planes_drive(np, s, data, 0, PLANES_A)
    q8 = planes_siso(np, data, None, backend="pallas_q8", planes=False)
    planes_drive(np, q8, data, 0, PLANES_Q8_A, tenants=False)
    torch.cuda.synchronize()
    (Path(out_dir) / "calls.json").write_text(json.dumps(
        {"launches": topk_launches(), "calls": sorted(recorder.calls)}))
    dev = q8.cache._dev
    CheckpointManager(os.path.join(out_dir, "ckpt")).save(1, {
        "siso": s.state_dict(), "q8": q8.state_dict(),
        "q8_live": {"codes": dev.codes, "scales": dev.scales}})
    os.kill(os.getpid(), signal.SIGKILL)


def phase_planes_kill(torch, np, seed: int, workdir: str) -> dict:
    """(a): the child serves and dies by SIGKILL while this process runs
    the same thing uninterrupted; then restore, warm_start, compare, and
    serve phase B in lockstep. The pallas_q8 snapshot is restored twice,
    as pallas_q8 and as dense: codes equal to the dead mirror's, phase-B
    decisions equal and sims bit-equal to dense."""
    import os
    import signal
    from repro_torch.checkpoint import CheckpointManager
    child_dir = os.path.join(workdir, "child")
    os.makedirs(child_dir)
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed),
         "--planes-child", child_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        data = planes_data(np, seed)
        t1 = time.perf_counter()
        s1 = planes_siso(np, data, os.path.join(workdir, "ref_cold"))
        boot_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        planes_drive(np, s1, data, 0, PLANES_A)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        _, err = child.communicate(timeout=PLANES_CHILD_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t0
    check(child.returncode == -signal.SIGKILL,
          f"[planes] the child did not die by SIGKILL (exit "
          f"{child.returncode}): {err[-2000:]}")
    ckpt = CheckpointManager(os.path.join(child_dir, "ckpt"))
    check(ckpt.all_steps() == [1], f"[planes] no full snapshot survived: "
                                   f"{ckpt.all_steps()}")
    t1 = time.perf_counter()
    rec = ckpt.restore(1)
    s2 = planes_siso(np, None, os.path.join(child_dir, "cold"))
    s2.load_state(rec["siso"])
    s2.warm_start()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    v1, v2 = planes_view(s1), planes_view(s2)
    for key in v1:
        check(same(np, v1[key], v2[key]),
              f"[planes] restored {key} differs from the uninterrupted run")
    m = v1["membership"]
    check(len(m["host"]) > 0 and len(m["disk"]) > 0
          and v1["tier_stats"]["promotions"] > 0
          and len(v1["tenants"]) == PLANES_TENANTS
          and any(len(o) for o in v1["overlays"].values()),
          f"[planes] the drill did not reach every plane: "
          f"{v1['tier_stats']}, overlays {v1['overlays']}")
    t1 = time.perf_counter()
    b1 = planes_drive(np, s1, data, PLANES_A, PLANES_A + PLANES_B)
    b2 = planes_drive(np, s2, data, PLANES_A, PLANES_A + PLANES_B)
    torch.cuda.synchronize()
    phase_b_s = time.perf_counter() - t1
    check(same(np, b1, b2), "[planes] phase B after the restore is not in "
                            "lockstep with the uninterrupted run")
    check(same(np, planes_view(s1), planes_view(s2)),
          "[planes] state after phase B differs")
    # the int8 plane: codes from the snapshot, decisions as dense
    live = rec["q8_live"]
    q8 = planes_siso(np, None, None, backend="pallas_q8", planes=False)
    dense = planes_siso(np, None, None, backend="dense", planes=False)
    for s in (q8, dense):
        s.load_state(rec["q8"])
        s.warm_start()
    n = len(rec["q8"]["cache"]["quant"]["codes"])
    dev = q8.cache._dev
    check(np.array_equal(dev.codes[:n].cpu().numpy(), live["codes"][:n])
          and np.array_equal(dev.scales[:n].cpu().numpy(),
                             live["scales"][:n])
          and np.array_equal(rec["q8"]["cache"]["quant"]["codes"],
                             live["codes"][:n]),
          "[planes] the restored int8 plane is not the dead process's")
    fb0 = q8.cache.quant_fallbacks
    lo, hi = PLANES_Q8_A, PLANES_Q8_A + PLANES_Q8_B
    r_q8 = planes_drive(np, q8, data, lo, hi, tenants=False)
    r_dense = planes_drive(np, dense, data, lo, hi, tenants=False)
    check(same(np, [{k: v for k, v in r.items() if k != "generation"}
                    for r in r_q8],
               [{k: v for k, v in r.items() if k != "generation"}
                for r in r_dense]),
          "[planes] restored pallas_q8 is not bitwise dense in phase B")
    calls = json.loads((Path(child_dir) / "calls.json").read_text())
    out = {"child_s": child_s, "bootstrap_s": boot_s, "serve_a_s": serve_s,
           "restore_s": restore_s, "phase_b_s": phase_b_s,
           "tier_stats": v1["tier_stats"],
           "tenants": {int(k): v for k, v in v1["tenants"].items()},
           "centroids": len(s1.cache.centroids),
           "mirror_rows": int(s1.cache.device._dev.pad),
           "q8_fallbacks_b": q8.cache.quant_fallbacks - fb0,
           "q8_rows": n, "child_launches": calls["launches"],
           "child_calls": [tuple(c) for c in calls["calls"]]}
    log(f"[planes] (a) kill drill: child SIGKILLed after {child_s:.1f} s "
        f"(this process bootstrapped {len(s1.cache.centroids)} centroid "
        f"rows in {boot_s:.1f} s, served {PLANES_A * PLANES_BATCH} "
        f"requests in {serve_s:.1f} s meanwhile); restored + warm_start in "
        f"{restore_s:.2f} s; tiers, tenants, counters and clock equal; "
        f"phase B ({PLANES_B * PLANES_BATCH} requests) in lockstep; "
        f"tier stats {v1['tier_stats']}")
    log(f"[planes] (a) pallas_q8: {n} restored code rows equal the dead "
        f"mirror's; phase B ({PLANES_Q8_B * PLANES_BATCH} requests) "
        f"decides as dense with bit-equal sims "
        f"({out['q8_fallbacks_b']} dense fallbacks)")
    return out


def restart_gateway(np, engine, train=None, persist_dir=None):
    """bench_restart's gateway: SISO (pallas) through
    ServingGateway.from_config, persistence attached when a directory is
    given; slo (b)'s blocking refresh and mis-set llm_latency."""
    from repro_torch.serving.config import (CacheConfig, PersistenceConfig,
                                            RefreshConfig, ServingConfig)
    from repro_torch.serving.gateway import ServingGateway
    from repro_torch.serving.simulator import bootstrap_frontend
    cfg = ServingConfig(
        cache=CacheConfig(dim=SIM_DIM, answer_dim=SIM_DIM,
                          capacity=SLO_CAPACITY, theta_r=SLO_THETA,
                          backend="pallas", dynamic_threshold=True),
        refresh=RefreshConfig(async_pipeline=False),
        persistence=(PersistenceConfig(directory=persist_dir, delta_every=4)
                     if persist_dir else None),
        slo_latency=SLO_S, llm_latency=0.2 * SLO_MAX_NEW * SLO_TICK_S)
    clock = VirtualClock()
    gw = ServingGateway.from_config(cfg, engine=engine,
                                    embed_fn=lambda vs: np.stack(vs),
                                    clock=clock)
    gw.frontend.threshold.lambda_window = SLO_LAMBDA_WINDOW
    if train is not None:
        bootstrap_frontend(gw.frontend, train)
    return gw, clock


def phase_planes_restart(torch, np, models, seed: int, workdir: str) -> dict:
    """(b): phase A with persistence attached (a refresh commit in it), a
    drained full snapshot and a delta at that boundary; phase B twice,
    uninterrupted and on a fresh gateway warm-started from a copy of the
    directory, which must match batch for batch; a cold gateway serves
    phase B for contrast."""
    import os
    import shutil
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.workloads import build_scenario
    mcfg, mparams = models[2], models[3]
    engine = ModelEngine(mparams, mcfg, n_slots=SLO_SLOTS, max_len=48,
                         device=DEV)
    scn = build_scenario("repeat_heavy", dim=SIM_DIM,
                         n_clusters=SLO_CLUSTERS, seed=seed,
                         n_train=RESTART_TRAIN,
                         n_test=RESTART_A + RESTART_B)
    live = os.path.join(workdir, "restart_live")
    survivor = os.path.join(workdir, "restart_survivor")
    t0 = time.perf_counter()
    gw1, c1 = restart_gateway(np, engine, scn.train, live)
    slo_drive(gw1, c1, scn.test, mcfg.vocab_size, seed=seed + 2,
              hi=RESTART_A)
    commits = gw1.stats.refreshes
    check(commits >= 1, f"[planes] (b) phase A made no refresh commit "
                        f"({gw1.report()['misses']} misses)")
    gw1.drain()                         # the drained full snapshot
    gw1.snapshot(full=False)            # and a delta at the boundary
    gw1.ckpt.wait()
    shutil.copytree(live, survivor)     # the disk that survives
    boundary = c1.t
    phase_a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = slo_drive(gw1, c1, scn.test, mcfg.vocab_size, seed=seed + 2,
                    lo=RESTART_A)
    gw1.drain()
    gw1.ckpt.wait()
    rep1 = gw1.report()
    ref_s = time.perf_counter() - t0
    gw2, c2 = restart_gateway(np, engine, persist_dir=survivor)
    meta = gw2.warm_start()
    c2.t = boundary
    t0 = time.perf_counter()
    warm = slo_drive(gw2, c2, scn.test, mcfg.vocab_size, seed=seed + 2,
                     lo=RESTART_A)
    gw2.drain()
    gw2.ckpt.wait()
    rep2 = gw2.report()
    warm_s = time.perf_counter() - t0
    check(meta["kind"] == "full+delta",
          f"[planes] (b) restored {meta['kind']}, not full+delta")
    check(same(np, ref, warm), "[planes] (b) the warm-started phase B's "
                               "per-batch hit masks differ")
    for k in ("hits", "misses", "hit_ratio", "submitted", "completed",
              "served_cache", "served_engine", "theta_r", "theta_trace",
              "mirror_generation", "refreshes"):
        check(rep1[k] == rep2[k], f"[planes] (b) {k} differs after the "
                                  f"warm restart: {rep1[k]} vs {rep2[k]}")
    gw3, c3 = restart_gateway(np, engine)
    c3.t = boundary
    cold = slo_drive(gw3, c3, scn.test, mcfg.vocab_size, seed=seed + 2,
                     lo=RESTART_A)
    gw3.drain()
    del engine
    torch.cuda.empty_cache()
    hr = {k: float(np.concatenate(v).mean()) if v else 0.0
          for k, v in (("ref", ref), ("warm", warm), ("cold", cold))}
    out = {"refresh_commits_a": commits, "restored": meta["kind"],
           "restored_step": meta["step"], "recovery_s": meta["recovery_s"],
           "hit_ratio_b": hr, "phase_a_s": phase_a_s, "ref_b_s": ref_s,
           "warm_b_s": warm_s, "generation": rep1["mirror_generation"],
           "served_b": (rep1["served_cache"], rep1["served_engine"])}
    log(f"[planes] (b) gateway warm restart: phase A ({RESTART_A} "
        f"requests, {commits} refresh commit(s)) in {phase_a_s:.1f} s; "
        f"restored {meta['kind']} (step {meta['step']}) in "
        f"{1e3 * meta['recovery_s']:.1f} ms; phase B ({RESTART_B} "
        f"requests) equal batch for batch (hit masks, counters, theta "
        f"trace, generation {rep1['mirror_generation']}); phase-B hit "
        f"ratio uninterrupted {hr['ref']:.4f}, warm {hr['warm']:.4f}, "
        f"cold {hr['cold']:.4f}")
    return out


def tier_drill(np, workdir: str) -> dict:
    """bench_tiered at its smoke size, dim 768: device-only against three
    tiers at equal device rows, fixed theta_R 0.92."""
    import os
    from repro_torch.core.siso import SISO, SISOConfig
    from repro_torch.core.tiered import TieredCacheConfig
    cap, n_topics, per_topic, steps, phase_len = 32, 16, 20, 900, 30
    rng = np.random.default_rng(0)
    d = SIM_DIM

    def norm(x):
        return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                               1e-9)).astype(np.float32)

    anchors = norm(rng.normal(size=(n_topics, d)))
    qs = norm(anchors.repeat(per_topic, axis=0) + 0.35 * DRILL_SCALE
              * rng.normal(size=(n_topics * per_topic, d)))
    answers = rng.normal(size=(len(qs), d)).astype(np.float32)
    topic = np.arange(n_topics).repeat(per_topic)
    by_topic = [np.flatnonzero(topic == t) for t in range(n_topics)]
    seen, seen_set = [], set()
    sched = np.empty(steps, np.int64)
    for i in range(steps):
        t = (i // phase_len) % n_topics
        if seen and rng.random() < 0.55:
            q = int(seen[int(rng.integers(len(seen)))])
        else:
            q = int(by_topic[t][int(rng.integers(len(by_topic[t])))])
        sched[i] = q
        if q not in seen_set:
            seen_set.add(q)
            seen.append(q)
    boot = rng.choice(len(qs), size=2 * cap, replace=False)
    out = {}
    for name in ("device_only", "tiered"):
        tiered = TieredCacheConfig(
            host_capacity=4 * cap, disk_capacity=16 * cap,
            disk_dir=os.path.join(workdir, "tier_drill_cold"),
            device_reserve=cap // 4, promote_budget=8) \
            if name == "tiered" else None
        s = SISO(SISOConfig(dim=d, answer_dim=d, capacity=cap,
                            theta_r=0.92, dynamic_threshold=False,
                            backend="pallas", refresh_async=False,
                            tiered=tiered), device=DEV)
        s.bootstrap(qs[boot], answers[boot], answer_ids=boot)
        r = np.random.default_rng(3)
        hits = np.zeros(steps, bool)
        t0 = time.perf_counter()
        for i, q in enumerate(sched):
            v = norm(qs[q] + 0.06 * DRILL_SCALE * r.normal(size=d))
            hits[i] = bool(s.handle_batch(v[None, :]).hit[0])
            if not hits[i]:
                s.record_llm_answer(v, answers[q], answer_id=int(q))
            s.refresh_tick(0.0)
        s.refresh_drain()
        out[name] = {"hit_ratio": float(hits[steps // 4:].mean()),
                     "wall_s": time.perf_counter() - t0}
        if tiered is not None:
            out[name]["tier_stats"] = s.cache.tier_stats()
    out["lift"] = out["tiered"]["hit_ratio"] - out["device_only"]["hit_ratio"]
    out["pressure_x"] = len(qs) / cap
    return out


def tenancy_drill(np) -> dict:
    """bench_tenancy at its smoke size, dim 768: the steady tenant's hit
    ratio alone (phase A) and under an 8:1 flood (phase B), weighted
    (tenancy on) and unweighted."""
    from repro_torch.core.siso import SISO, SISOConfig
    from repro_torch.core.tenancy import TenancyConfig
    cap, n_topics, n_a, n_b = 64, 16, 96, 432
    d = SIM_DIM
    rng = np.random.default_rng(0)

    def norm(x):
        return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                               1e-9)).astype(np.float32)

    topics = norm(rng.normal(size=(n_topics, d)))
    stream, k = [], 0
    for _ in range(n_a):
        stream.append((1, norm(topics[k % n_topics] + 0.02 * DRILL_SCALE
                                * rng.normal(size=d))))
        k += 1
    for i in range(n_b):
        if i % 9 == 8:
            stream.append((1, norm(topics[k % n_topics] + 0.02 * DRILL_SCALE
                                    * rng.normal(size=d))))
            k += 1
        else:
            stream.append((0, norm(rng.normal(size=d))))
    tenants = np.asarray([t for t, _ in stream], np.int64)
    vecs = np.stack([v for _, v in stream])
    answers = rng.normal(size=(len(stream), d)).astype(np.float32)
    out = {}
    for name, ten in (("weighted", TenancyConfig()), ("unweighted", None)):
        s = SISO(SISOConfig(dim=d, answer_dim=d, capacity=cap, theta_r=0.92,
                            dynamic_threshold=False, backend="pallas",
                            refresh_async=False, tenancy=ten), device=DEV)
        hits = np.zeros(len(stream), bool)
        for i in range(len(stream)):
            kw = {"tenant_ids": tenants[i:i + 1]} if ten else {}
            hits[i] = bool(s.handle_batch(vecs[i][None, :], now=float(i),
                                          **kw).hit[0])
            if not hits[i]:
                s.record_llm_answer(vecs[i], answers[i], answer_id=i,
                                    tenant=int(tenants[i]) if ten else None)
        st = tenants == 1
        a = float(hits[:n_a][st[:n_a]][n_topics:].mean())
        b = float(hits[n_a:][st[n_a:]].mean())
        out[name] = {"steady_hit_a": a, "steady_hit_b": b,
                     "rel_degradation": max(0.0, a - b) / max(a, 1e-9)}
    return out


def phase_planes(torch, np, models, recorder, att_recorders,
                 seed: int) -> dict:
    """Phase 7: the kill drill (a), the gateway warm restart (b) and the
    tier and tenancy drills (c). K1-K4 launch counters are zeroed just
    before and read just after; the killed child's K1/K2 launches and
    calls come back in a file beside its snapshot. Every K1/K2 call (the
    child's too) and every K3/K4 call is noted for the re-checks at its
    own arguments."""
    import os
    import shutil
    from repro_torch.core import semantic_cache as SC
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import layers as L
    workdir = ROOT / "build" / f"planes-{os.getpid()}"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    torch.cuda.synchronize()
    zero_topk_launches()
    zero_attention_launches()
    SC.ctk_ops = recorder
    t0 = time.perf_counter()
    try:
        with recorded_ops(L, att_recorders):
            kill = phase_planes_kill(torch, np, seed, str(workdir))
            t1 = time.perf_counter()
            restart = phase_planes_restart(torch, np, models, seed,
                                           str(workdir))
            restart_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            tiers = tier_drill(np, str(workdir))
            tenancy = tenancy_drill(np)
            drills_s = time.perf_counter() - t1
        torch.cuda.synchronize()
    finally:
        SC.ctk_ops = ops
        shutil.rmtree(workdir, ignore_errors=True)
    n = {**topk_launches(), **attention_launches()}
    for fn, c in kill.pop("child_launches").items():
        n[fn] += c
    recorder.calls.update(kill.pop("child_calls"))
    check(n["cosine_topk"] > 0 and n["cosine_topk_q8"] > 0
          and n["flash_attention"] > 0 and n["decode_attention"] > 0,
          f"[planes] a kernel of the phase was never launched: {n}")
    log(f"[planes] (c) tiers at dim {SIM_DIM} ({tiers['pressure_x']:.0f}x "
        f"the device rows): steady hit ratio device-only "
        f"{tiers['device_only']['hit_ratio']:.4f}, three tiers "
        f"{tiers['tiered']['hit_ratio']:.4f} (lift {tiers['lift']:+.4f}); "
        f"tier stats {tiers['tiered']['tier_stats']}")
    log(f"[planes] (c) tenancy at dim {SIM_DIM}: steady tenant alone / "
        f"under the 8:1 flood: weighted {tenancy['weighted']['steady_hit_a']:.4f} / "
        f"{tenancy['weighted']['steady_hit_b']:.4f} (relative degradation "
        f"{tenancy['weighted']['rel_degradation']:.4f}), unweighted "
        f"{tenancy['unweighted']['steady_hit_a']:.4f} / "
        f"{tenancy['unweighted']['steady_hit_b']:.4f} "
        f"({tenancy['unweighted']['rel_degradation']:.4f})")
    wall = time.perf_counter() - t0
    log(f"[planes] phase done in {wall:.1f} s (kill drill "
        f"{wall - restart_s - drills_s:.1f} s, gateway restart "
        f"{restart_s:.1f} s, tier + tenancy drills {drills_s:.1f} s); "
        f"launches {n}")
    return {"kill": kill, "restart": restart, "tiers": tiers,
            "tenancy": tenancy, "launches": n, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 8: replicas (the replica plane, its transports, the HTTP front end)
# ---------------------------------------------------------------------------

# (a) the HTTP stream: REPL_PAIRS fresh queries from user 0 (replica r0),
# each repeated by user 1 (replica r1), then anonymous traffic
REPL_PAIRS, REPL_ANON, REPL_MAX_NEW, REPL_PROMPT = 6, 4, 4, 8
REPL_UPDATES = 3        # q8 run: identities r0 re-answers (update_spill_row)
# the embedder's weights are random, so unrelated prompts already sit at
# cosine ~0.96 ((a) logs the largest); a repeat is exact (1.0)
REPL_HTTP_THETA = 0.999
# (b)/(c): benchmarks/bench_replica.py's drills at their smoke sizes, dim
# 768, noise scaled by sqrt(32/768); the engines are qwen3-14b at full
# width cut to REPL_DRILL_LAYERS layers, seeded alike in parent and child
REPL_DRILL_LAYERS = 2
REPL_CLUSTERS, REPL_TRAIN, REPL_TEST = 16, 96, 64
REPL_CAPACITY, REPL_THETA, REPL_SLOTS = 256, 0.86, 2
REPL_DRILL_NEW, REPL_TICK_S, REPL_CHUNK = 6, 0.05, 8
REPL_SNAPSHOTS = 3      # the child is killed once this many are on disk
REPL_CHILD_S = 300.0    # a child's time limit
REPL_SERVE_S = 180.0    # (d): the launcher's start-up deadline


def repl_drill_models(torch, seed: int):
    """(b)/(c)'s engine weights: qwen3-14b at full width, depth cut."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    mcfg = get_config("qwen3-14b").replace(n_layers=REPL_DRILL_LAYERS)
    return mcfg, lm.init_params(gen(torch, seed + 2), mcfg, device=DEV)


def repl_workload(np, n_replicas: int, seed: int):
    """bench_replica's workload at dim 768: zipf-popular clusters, each
    with a home replica, 35% of traffic spilled to a random peer. Returns
    (train, centers, stream of (arrival, replica, cluster, q, answer))."""
    rng = np.random.default_rng(seed)
    d = SIM_DIM

    def norm(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    train = norm(rng.standard_normal((REPL_TRAIN, d)))
    centers = norm(rng.standard_normal((REPL_CLUSTERS, d)))
    p = 1.0 / np.arange(1, REPL_CLUSTERS + 1) ** 1.1
    cids = rng.choice(REPL_CLUSTERS, size=REPL_TEST, p=p / p.sum())
    arrivals = np.cumsum(rng.exponential(0.015, size=REPL_TEST))
    spill = rng.random(REPL_TEST) < 0.35
    alt = rng.integers(0, n_replicas, size=REPL_TEST)
    stream = []
    for i in range(REPL_TEST):
        c = int(cids[i])
        r = int(alt[i]) if spill[i] else c % n_replicas
        q = norm(centers[c] + 0.02 * DRILL_SCALE * rng.standard_normal(d))
        stream.append((float(arrivals[i]), r, c, q, centers[c]))
    return train, centers, stream


def repl_repeat_chances(stream) -> int:
    """Phase-1 requests whose cluster was first asked at least one miss's
    engine time earlier (prefill + REPL_DRILL_NEW ticks): the repeats
    that could hit a recorded answer."""
    first, n = {}, 0
    for t, _, c, _, _ in stream[:len(stream) // 2]:
        if c in first and t - first[c] > (REPL_DRILL_NEW + 1) * REPL_TICK_S:
            n += 1
        first.setdefault(c, t)
    return n


def repl_probe(np, centers, stream):
    """The drills' probe: the clusters phase 1 saw, re-noised."""
    rng = np.random.default_rng(99)
    seen = sorted({c for _, _, c, _, _ in stream[:len(stream) // 2]})
    q = centers[seen] + 0.02 * DRILL_SCALE * rng.standard_normal(
        (len(seen), SIM_DIM))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
        np.float32)


def repl_gateway(np, engine, clock, train, persist_dir=None):
    """bench_replica's replica image on backend pallas (K1): fixed theta,
    refresh suppressed (one commit epoch for the run)."""
    from repro_torch.serving.config import (CacheConfig, PersistenceConfig,
                                            RefreshConfig, ServingConfig)
    from repro_torch.serving.gateway import ServingGateway
    cfg = ServingConfig(
        cache=CacheConfig(dim=SIM_DIM, answer_dim=SIM_DIM,
                          capacity=REPL_CAPACITY, theta_r=REPL_THETA,
                          backend="pallas", dynamic_threshold=False),
        refresh=RefreshConfig(frac=1000.0, min=10_000_000,
                              async_pipeline=False),
        persistence=(PersistenceConfig(directory=persist_dir,
                                       delta_every=1)
                     if persist_dir else None),
        slo_latency=1.3 * REPL_DRILL_NEW * REPL_TICK_S)
    gw = ServingGateway.from_config(cfg, engine=engine,
                                    embed_fn=lambda vs: np.stack(vs),
                                    clock=clock)
    gw.frontend.bootstrap(train, train, answer_ids=np.arange(len(train)))
    return gw


def repl_engines(mcfg, mparams, n: int):
    from repro_torch.serving.engine import ModelEngine
    return [ModelEngine(mparams, mcfg, n_slots=REPL_SLOTS, max_len=48,
                        device=DEV) for _ in range(n)]


def repl_drive(np, targets, clock, stream, lo: int = 0, hi=None,
               rid_base: int = 10_000, after_submit=None):
    """bench_replica's drive loop: submit stream[lo:hi] to its routed
    target as arrivals come due (chunks of REPL_CHUNK), one engine tick
    per REPL_TICK_S of virtual time. Returns the flat hit mask."""
    from repro_torch.serving.gateway import GatewayRequest
    hi = len(stream) if hi is None else hi
    gws = [getattr(t, "gw", t) for t in targets]
    hits, i = [], lo
    for _ in range(500_000):
        idle = all(not g.sched.queue and not g.sched.active for g in gws)
        if i >= hi and idle:
            return np.concatenate(hits) if hits else np.zeros(0, bool)
        due = [[] for _ in targets]
        while i < hi and stream[i][0] <= clock.t:
            _, r, c, q, ans = stream[i]
            due[r % len(targets)].append(GatewayRequest(
                rid=rid_base + i,
                model_tokens=np.asarray([c % 97, 1, 2], np.int32),
                embed_tokens=q, max_new=REPL_DRILL_NEW, answer_vec=ans))
            i += 1
        if any(due):
            for r, reqs in enumerate(due):
                for j in range(0, len(reqs), REPL_CHUNK):
                    hits.append(np.asarray(targets[r].submit(
                        reqs[j: j + REPL_CHUNK], now=clock.t)).copy())
                    if after_submit is not None:
                        after_submit()
            clock.t += REPL_TICK_S
        else:
            for g in gws:
                g.step()
            clock.t += REPL_TICK_S
            if idle and i < hi and stream[i][0] > clock.t:
                clock.t = float(stream[i][0])
    raise PhaseError("[replicas] drive loop exceeded its ticks")


def repl_view(res) -> dict:
    """What a rejoined replica must reproduce element-wise."""
    return {f: getattr(res, f).copy()
            for f in ("hit", "sim", "region", "answer_id")}


def steps_on_disk(d: str) -> list:
    import os
    try:
        return sorted(int(n.split("_")[1]) for n in os.listdir(d)
                      if n.startswith("step_") and "tmp" not in n)
    except (FileNotFoundError, ValueError):
        return []


def write_json(path: Path, obj) -> None:
    """Atomic: a reader never sees half a file."""
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.replace(path)


def tuplify(x):
    """A call signature read back from JSON (lists) as the tuples the
    recorders note."""
    return tuple(tuplify(v) for v in x) if isinstance(x, list) else x


def replicas_child(torch, np, spec_path: str) -> None:
    """A killed replica process of (b) or (c). It serves its share of
    phase 1 with replica B snapshotting; once REPL_SNAPSHOTS snapshots are
    on disk it writes its kernel launches and calls to ``calls.json``
    and ``ready``, then waits for its SIGKILL (exiting by itself after
    REPL_CHILD_S)."""
    import os
    from repro_torch.core import semantic_cache as SC
    from repro_torch.distributed.replication import (Replica, ReplicaGroup,
                                                     ReplicationConfig)
    from repro_torch.distributed.transport import (SocketTransport,
                                                   TransportConfig)
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    recorder = CallRecorder(ops)
    att = (OpsRecorder(fa_ops), OpsRecorder(da_ops))
    SC.ctk_ops = recorder
    zero_topk_launches()
    zero_attention_launches()
    mcfg, mparams = repl_drill_models(torch, spec["seed"])
    train, _, stream = repl_workload(np, 2, seed=1)
    clock = VirtualClock()

    def maybe_ready():
        if len(steps_on_disk(spec["dir"])) < REPL_SNAPSHOTS:
            return
        torch.cuda.synchronize()
        write_json(out / "calls.json", {
            "launches": {**topk_launches(), **attention_launches()},
            "calls": sorted(recorder.calls),
            "att_calls": sorted(att[0].distinct() | att[1].distinct(),
                                key=repr)})
        (out / "ready").write_text("1")
        time.sleep(REPL_CHILD_S)
        os._exit(3)                 # never killed: the parent has gone

    with recorded_ops(L, att):
        if spec["kind"] == "inproc":
            engines = repl_engines(mcfg, mparams, 2)
            group = ReplicaGroup(ReplicationConfig(sync_every=1,
                                                   apply_budget=64))
            ra = group.add("a", repl_gateway(np, engines[0], clock, train))
            rb = group.add("b", repl_gateway(np, engines[1], clock, train,
                                             spec["dir"]))
            rb.gw.snapshot(full=True)
            repl_drive(np, [ra, rb], clock, stream, hi=len(stream) // 2,
                       after_submit=maybe_ready)
            group.drain_all()
            ckpt = rb.gw.ckpt
        else:
            engine = repl_engines(mcfg, mparams, 1)[0]
            gw = repl_gateway(np, engine, clock, train, spec["dir"])
            # no state provider: nothing in the drill reconciles from B,
            # so no transport thread of this process touches the card
            t = SocketTransport("b", TransportConfig(kind="socket"))
            rep = Replica("b", gw, t)
            t.connect("a", ("127.0.0.1", spec["port_a"]))
            write_json(out / "port_b.json", {"port": t.address[1]})
            gw.snapshot(full=True)
            mine = [s for s in stream[:len(stream) // 2] if s[1] == 1]
            repl_drive(np, [rep], clock, mine, rid_base=50_000,
                       after_submit=maybe_ready)
            rep.drain()
            ckpt = gw.ckpt
        # the writer thread may still hold phase 1's last snapshots (the
        # drain's full among them): count the disk once they are written
        ckpt.wait()
        maybe_ready()
    # phase 1 ended before the snapshots did: say so to the parent
    write_json(out / "calls.json", {"error": "phase 1 ended with "
                                    f"{steps_on_disk(spec['dir'])} on disk"})
    (out / "ready").write_text("1")
    time.sleep(REPL_CHILD_S)
    os._exit(3)


def repl_child_argv(seed: int, spec_path: Path) -> list:
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
            str(seed), "--replicas-child", str(spec_path)]


def repl_child_calls(out: Path) -> dict:
    got = json.loads((out / "calls.json").read_text())
    check("error" not in got, f"[replicas] child: {got.get('error')}")
    return {"launches": got["launches"],
            "calls": [tuplify(c) for c in got["calls"]],
            "att_calls": [tuplify(c) for c in got["att_calls"]]}


def replicas_http(torch, np, models, backend: str, sync_every: int,
                  seed: int) -> dict:
    """(a): two Replicas (each a from_config gateway over its own
    ModelEngine on the served weights, the served embedder on every
    request) behind the port's CacheHTTPServer, driven by urllib. On
    pallas_q8, r0 then re-answers REPL_UPDATES identities r1 holds, and
    r1's patched rows (update_spill_row re-quantizes them) must decide as
    a dense replica cloned from r1 and fed the same record, with bit-equal
    sims."""
    import threading
    import urllib.error
    import urllib.request
    from repro_torch.distributed.replication import (ReplicaGroup,
                                                     ReplicationConfig)
    from repro_torch.launch.serve import CacheHTTPServer, hash_embed_fn
    from repro_torch.models import embedder as E
    from repro_torch.serving.config import (CacheConfig, RefreshConfig,
                                            ServingConfig)
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import ServingGateway
    ecfg, eparams, mcfg, mparams = models
    dim = ecfg.d_model
    answer = hash_embed_fn(dim)

    def embed(token_lists):
        # the served embedder over the request tokens; grad mode is per
        # thread, and this runs on the server's handler threads
        ids = np.zeros((len(token_lists), 24), np.int32)
        for i, t in enumerate(token_lists):
            ids[i, :len(t)] = t
        with torch.inference_mode():
            return E.encode(eparams, ecfg, torch.tensor(ids, device=DEV),
                            torch.tensor(ids > 0, device=DEV)).cpu().numpy()

    def gateway(backend_, engine):
        cfg = ServingConfig(
            cache=CacheConfig(dim=dim, answer_dim=dim, capacity=256,
                              backend=backend_, theta_r=REPL_HTTP_THETA,
                              dynamic_threshold=False),
            refresh=RefreshConfig(min=10_000))
        return ServingGateway.from_config(
            cfg, engine=engine, embed_fn=embed,
            answer_fn=lambda t: answer([t])[0])

    engines = [ModelEngine(mparams, mcfg, n_slots=2, max_len=48,
                           device=DEV) for _ in range(2)]
    group = ReplicaGroup(ReplicationConfig(sync_every=sync_every,
                                           apply_budget=64))
    reps = [group.add(f"r{i}", gateway(backend, engines[i]))
            for i in range(2)]
    server = CacheHTTPServer(("127.0.0.1", 0), reps, ["r0", "r1"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)

    def query(tokens, user=None):
        body = {"tokens": [int(t) for t in tokens], "max_new": REPL_MAX_NEW}
        if user is not None:
            body["user"] = user
        req = urllib.request.Request(
            f"{url}/v1/query", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120.0) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    rng = np.random.default_rng(seed + 80)
    vocab = min(ecfg.vocab_size, mcfg.vocab_size)
    prompts = rng.integers(1, vocab, size=(REPL_PAIRS + REPL_ANON // 2,
                                           REPL_PROMPT))
    stream = []
    for i in range(REPL_PAIRS):
        stream += [(prompts[i], 0), (prompts[i], 1)]
    for j in range(REPL_ANON // 2):
        stream += [(prompts[REPL_PAIRS + j], None), (prompts[j], None)]
    thread.start()
    t0 = time.perf_counter()
    try:
        resp = [query(t, u) for t, u in stream]
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{url}/healthz", timeout=60.0) as r:
            health = json.loads(r.read())
        server.begin_drain()
        refused = query(prompts[0], 0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(server.failed is None, f"[replicas] (a) the front end failed: "
                                 f"{server.failed!r}")
    for st, hdr, body in resp:
        check(st == 200 and all(k in hdr for k in
                                ("X-Cache", "X-Cache-Region", "X-Replica")),
              f"[replicas] (a) a response lacks its status or headers: "
              f"{st} {hdr} {body}")
    pairs = [(resp[2 * i], resp[2 * i + 1]) for i in range(REPL_PAIRS)]
    for first, again in pairs:
        check(first[1]["X-Cache"] == "MISS"
              and first[1]["X-Replica"] == "r0",
              f"[replicas] (a) a fresh query was not a MISS on r0: "
              f"{first[1]}")
        if sync_every:
            check(again[1]["X-Cache"] == "HIT"
                  and again[1]["X-Cache-Region"] == "spill"
                  and again[1]["X-Replica"] == "r1",
                  f"[replicas] (a) {backend}: the peer's repeat was not a "
                  f"spill HIT on r1: {again[1]}")
        else:
            check(again[1]["X-Cache"] == "MISS",
                  f"[replicas] (a) an isolated replica hit a repeat it "
                  f"never served: {again[1]}")
    rep_h = {n: health["replicas"].get(n, {}).get("replication")
             for n in ("r0", "r1")}
    check(all(r is not None and "transport" in r and "merged_rows" in r
              for r in rep_h.values()),
          f"[replicas] (a) /healthz lacks a replica's stats: {health}")
    check(refused[0] == 503 and refused[1].get("Retry-After") == "1",
          f"[replicas] (a) a query after the drain got {refused[0]} "
          f"{refused[1]}")
    merged = reps[1].merged_rows
    if sync_every:
        check(merged >= 1, "[replicas] (a) r1 merged no row")
    hits = [bool(body["hit"]) for _, _, body in resp]
    e = embed(list(prompts))
    cos = e @ e.T
    unrelated = float(cos[~np.eye(len(e), dtype=bool)].max())
    check(unrelated < REPL_HTTP_THETA, f"[replicas] (a) two distinct "
                                       f"prompts embed at cosine {unrelated}")
    out = {"backend": backend, "sync_every": sync_every, "wall_s": wall,
           "max_unrelated_cos": unrelated,
           "hits": int(sum(hits)), "requests": len(resp),
           "pair_hits": sum(a[2]["hit"] for _, a in pairs),
           "merged_rows": merged, "health": rep_h}
    if backend == "pallas_q8":
        out["q8"] = repl_q8_updates(np, reps, gateway, engines[1], answer,
                                    embed, prompts)
    return out


def repl_q8_updates(np, reps, gateway, engine, answer, embed,
                    prompts) -> dict:
    """r0 re-answers REPL_UPDATES identities r1 merged: r1 applies the
    record through update_spill_row (its q8 mirror re-quantizes each
    row); a dense replica cloned from r1 applies the same record. Their
    lookups must decide alike with bit-equal sims."""
    from repro_torch.distributed.replication import Replica, ReplicaGroup
    r0, r1 = reps
    c0, c1 = r0.gw.frontend.cache, r1.gw.frontend.cache
    dense = Replica("d", gateway("dense", engine),
                    ReplicaGroup().log)        # a log of its own
    dense._adopt_reconcile(*r1._reconcile_payload(copy=True))
    aids = [int(a) for a in c1.spill.answer_id if a >= 0][:REPL_UPDATES]
    check(len(aids) == REPL_UPDATES, f"[replicas] (a) r1 holds only "
                                     f"{len(aids)} merged identities")
    rng = np.random.default_rng(3)
    new_vecs = []
    for aid in aids:
        row = int(np.nonzero(c0.spill.answer_id == aid)[0][-1])
        v = c0.spill.vectors[row] + 0.5 / np.sqrt(c0.spill.vectors.shape[1]) \
            * rng.standard_normal(c0.spill.vectors.shape[1])
        v = (v / np.linalg.norm(v)).astype(np.float32)
        new_vecs.append(v)
        r0.gw.frontend.record_llm_answer(
            v, answer([np.asarray([aid, 1])])[0], answer_id=aid)
    rows = {a: int(np.nonzero(c1.spill.answer_id == a)[0][0]) for a in aids}
    writes = c1.dev_row_writes
    rec = r0.publish(r0.gw.clock())
    merged0 = r1.merged_rows
    check(r1.apply(rec) and dense.apply(rec),
          "[replicas] (a) the update record was refused")
    check(r1.merged_rows - merged0 == REPL_UPDATES
          and c1.dev_row_writes - writes == REPL_UPDATES
          and all(int(c1.spill.answer_id[r]) == a for a, r in rows.items()),
          "[replicas] (a) the updates did not patch r1's rows in place")
    q = np.concatenate([np.stack(new_vecs), embed(list(prompts))])
    fb = c1.quant_fallbacks
    got = c1.lookup(q.copy(), REPL_HTTP_THETA)
    want = dense.gw.frontend.cache.lookup(q.copy(), REPL_HTTP_THETA)
    for f in ("hit", "sim", "answer_id", "entry", "region"):
        check(np.array_equal(getattr(got, f), getattr(want, f)),
              f"[replicas] (a) pallas_q8 after update_spill_row differs "
              f"from dense in {f}")
    check(bool(got.hit[:REPL_UPDATES].all())
          and [int(a) for a in got.answer_id[:REPL_UPDATES]] == aids,
          "[replicas] (a) a patched row does not serve its new vector")
    return {"patched_rows": REPL_UPDATES, "probe": len(q),
            "probe_hits": int(got.hit.sum()),
            "dense_fallbacks": c1.quant_fallbacks - fb}


def replicas_kill_inproc(torch, np, drill, seed: int, workdir: Path) -> dict:
    """(b): bench_replica's run_drill. A child serves phase 1 on a
    2-replica group with B snapshotting and is SIGKILLed (spawn_and_kill);
    this process replays phase 1 on a never-killed group, then rejoins a
    fresh replica from B's disk: warm_start, then add(reconcile=True).
    The rejoined replica's lookups must equal the donor's element-wise."""
    from repro_torch.distributed.fault_tolerance import spawn_and_kill
    from repro_torch.distributed.replication import (ReplicaGroup,
                                                     ReplicationConfig)
    out = workdir / "inproc_child"
    out.mkdir()
    ckpt = workdir / "inproc_b"
    spec = workdir / "inproc_spec.json"
    spec.write_text(json.dumps({"kind": "inproc", "dir": str(ckpt),
                                "out": str(out), "seed": seed}))
    killed, ran_s = spawn_and_kill(repl_child_argv(seed, spec),
                                   ready=lambda: (out / "ready").exists(),
                                   timeout_s=REPL_CHILD_S)
    check(killed, "[replicas] (b) the child exited before its SIGKILL")
    child = repl_child_calls(out)
    steps = steps_on_disk(str(ckpt))
    t0 = time.perf_counter()
    mcfg, mparams = drill
    train, centers, stream = repl_workload(np, 2, seed=1)
    engines = repl_engines(mcfg, mparams, 2)
    clock = VirtualClock()
    group = ReplicaGroup(ReplicationConfig(sync_every=1, apply_budget=64))
    ra = group.add("a", repl_gateway(np, engines[0], clock, train))
    rb = group.add("b", repl_gateway(np, engines[1], clock, train))
    hits = repl_drive(np, [ra, rb], clock, stream, hi=len(stream) // 2)
    group.drain_all()
    group.sync_all(clock.t)
    gw2 = repl_gateway(np, engines[1], clock, train, str(ckpt))
    meta = gw2.warm_start()
    r2 = group.add("b2", gw2, reconcile=True)
    donor = group.donor_for(r2)
    probe = repl_probe(np, centers, stream)
    want = repl_view(donor.gw.frontend.handle_batch(probe.copy(),
                                                    now=clock.t))
    got = repl_view(r2.gw.frontend.handle_batch(probe.copy(), now=clock.t))
    torch.cuda.synchronize()
    check(same(np, want, got), "[replicas] (b) the rejoined replica's "
                               "lookups differ from the donor's")
    check(want["hit"].any(), "[replicas] (b) the probe hit nothing")
    res = {"child_s": ran_s, "snapshots": len(steps),
           "restored": meta["kind"], "recovery_s": meta["recovery_s"],
           "donor": donor.name, "probe": len(probe),
           "probe_hits": int(want["hit"].sum()),
           "phase1_hit_ratio": float(hits.mean()),
           "phase1_repeat_chances": repl_repeat_chances(stream),
           "replay_s": time.perf_counter() - t0, "child": child}
    log(f"[replicas] (b) kill and rejoin: child SIGKILLed after "
        f"{ran_s:.1f} s with {len(steps)} snapshot(s) on disk; phase 1 "
        f"replayed (hit ratio {res['phase1_hit_ratio']:.4f}; "
        f"{res['phase1_repeat_chances']} requests repeat a cluster asked "
        f"one miss's engine time before), restored "
        f"{meta['kind']} in {1e3 * meta['recovery_s']:.1f} ms, cloned "
        f"{donor.name}; probe {res['probe_hits']}/{len(probe)} hits, "
        f"element-wise equal to the donor")
    return res


def replicas_kill_socket(torch, np, drill, seed: int, workdir: Path) -> dict:
    """(c), first part: bench_replica's run_drill_socket. Replica B runs
    in a child over SocketTransport on loopback and is SIGKILLed
    mid-stream; its successor warm-starts from B's disk and reconciles
    through fetch_state; its probes must equal A's."""
    import signal
    from repro_torch.distributed.replication import Replica
    from repro_torch.distributed.transport import (SocketTransport,
                                                   TransportConfig)
    out = workdir / "socket_child"
    out.mkdir()
    ckpt = workdir / "socket_b"
    mcfg, mparams = drill
    train, centers, stream = repl_workload(np, 2, seed=1)
    engines = repl_engines(mcfg, mparams, 2)
    clock = VirtualClock()
    ta = SocketTransport("a", TransportConfig(kind="socket"))
    tb2 = None
    ra = Replica("a", repl_gateway(np, engines[0], clock, train), ta)
    ta.state_provider = lambda: ra._reconcile_payload(copy=False)
    spec = workdir / "socket_spec.json"
    spec.write_text(json.dumps({"kind": "socket", "dir": str(ckpt),
                                "out": str(out), "seed": seed,
                                "port_a": ta.address[1]}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(repl_child_argv(seed, spec))
    try:
        while not (out / "port_b.json").exists():
            check(proc.poll() is None and time.perf_counter() - t0
                  < REPL_CHILD_S, "[replicas] (c) the socket child never "
                                  "listened")
            time.sleep(0.05)
        port_b = json.loads((out / "port_b.json").read_text())["port"]
        ta.connect("b", ("127.0.0.1", port_b))
        mine = [s for s in stream[:len(stream) // 2] if s[1] == 0]
        killed, i = False, 0
        while time.perf_counter() - t0 < REPL_CHILD_S:
            if not killed and (out / "ready").exists():
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                killed = proc.returncode == -signal.SIGKILL
            if i < len(mine):
                nxt = min(i + REPL_CHUNK, len(mine))
                repl_drive(np, [ra], clock, mine, lo=i, hi=nxt)
                i = nxt
            elif killed or proc.poll() is not None:
                break
            else:
                time.sleep(0.05)
        child_s = time.perf_counter() - t0
        check(killed, "[replicas] (c) the socket child was not SIGKILLed "
                      "while alive")
        child = repl_child_calls(out)
        ra.drain()
        steps = steps_on_disk(str(ckpt))
        gw2 = repl_gateway(np, engines[1], clock, train, str(ckpt))
        meta = gw2.warm_start()
        tb2 = SocketTransport("b2", TransportConfig(kind="socket"))
        r2 = Replica("b2", gw2, tb2)
        tb2.state_provider = lambda: r2._reconcile_payload(copy=False)
        tb2.connect("a", ta.address)
        ta.connect("b2", tb2.address)
        r2._reconcile_due = True        # the disk state is stale
        r2.apply_pending(None)          # -> fetch_state over the wire
        check(r2.reconciles == 1, "[replicas] (c) the successor did not "
                                  "reconcile over the transport")
        probe = repl_probe(np, centers, stream)
        want = repl_view(ra.gw.frontend.handle_batch(probe.copy(),
                                                     now=clock.t))
        got = repl_view(r2.gw.frontend.handle_batch(probe.copy(),
                                                    now=clock.t))
        torch.cuda.synchronize()
        check(same(np, want, got), "[replicas] (c) the successor's probes "
                                   "differ from A's")
        stats = ta.stats()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        ta.close()
        if tb2 is not None:
            tb2.close()
    res = {"child_s": child_s, "snapshots": len(steps),
           "restored": meta["kind"], "probe": len(probe),
           "probe_hits": int(want["hit"].sum()),
           "transport": stats, "child": child}
    log(f"[replicas] (c) socket kill and rejoin: B SIGKILLed after "
        f"{child_s:.1f} s with {len(steps)} snapshot(s); successor "
        f"restored {meta['kind']} and fetched A's state over TCP; probe "
        f"{res['probe_hits']}/{len(probe)} hits, equal to A's; A's "
        f"transport sent {sum(p['sent'] for p in stats['peers'].values())} "
        f"frames")
    return res


def replicas_socket_faults(torch, np, drill) -> dict:
    """(c), second part: bench_replica's run_socket_faults. R=3 over
    sockets with per-record delays, every third record per link dropped
    and an r0<->r1 partition that heals; after the stream the faults are
    lifted, the group drains and settles in two publish rounds, and every
    replica must then give identical lookup content."""
    from repro_torch.distributed.fault_tolerance import NetworkFaultHooks
    from repro_torch.distributed.replication import (ReplicaGroup,
                                                     ReplicationConfig)
    from repro_torch.distributed.transport import TransportConfig
    mcfg, mparams = drill
    train, centers, stream = repl_workload(np, 3, seed=2)
    engines = repl_engines(mcfg, mparams, 3)
    clock = VirtualClock()
    hooks = NetworkFaultHooks(delay_s=0.001, drop_every=3)
    group = ReplicaGroup(
        ReplicationConfig(n_replicas=3, sync_every=1, apply_budget=64,
                          transport=TransportConfig(kind="socket")),
        fault_hooks=hooks)
    try:
        reps = [group.add(f"r{k}", repl_gateway(np, engines[k], clock,
                                                train)) for k in range(3)]
        t0 = time.perf_counter()
        third = len(stream) // 3
        repl_drive(np, reps, clock, stream, hi=third)
        hooks.partition("r0", "r1")
        repl_drive(np, reps, clock, stream, lo=third, hi=2 * third)
        hooks.heal()
        repl_drive(np, reps, clock, stream, lo=2 * third)
        stream_s = time.perf_counter() - t0
        dropped, delayed = hooks.dropped, hooks.delayed
        hooks.drop_every, hooks.delay_s = 0, 0.0
        group.drain_all()
        rounds = []
        for _ in range(2):
            t1 = time.perf_counter()
            for r in reps:
                r.publish(clock.t)
            rounds.append({"settled": group.barrier(60.0),
                           "s": time.perf_counter() - t1})
        probe = centers + 0.02 * DRILL_SCALE * np.random.default_rng(
            11).standard_normal(centers.shape)
        probe = (probe / np.linalg.norm(probe, axis=-1, keepdims=True)
                 ).astype(np.float32)
        res = [r.gw.frontend.handle_batch(probe.copy(), now=clock.t)
               for r in reps]
        torch.cuda.synchronize()
        gaps = sum(r.gap_reconciles for r in reps)
        out = {"dropped": dropped, "delayed": delayed, "gap_reconciles": gaps,
               "reconciles": sum(r.reconciles for r in reps),
               "rounds": rounds, "stream_s": stream_s,
               "hit_ratio": float(np.mean([x.hit.mean() for x in res]))}
    finally:
        group.close()
    check(all(r["settled"] for r in rounds),
          f"[replicas] (c) the group did not settle: {rounds}")
    for k, x in enumerate(res[1:], 1):
        check(all(np.array_equal(getattr(res[0], f), getattr(x, f))
                  for f in ("hit", "answer_id", "region")),
              f"[replicas] (c) r{k}'s lookup content differs from r0's "
              f"after two settle rounds")
    check(dropped > 0 and delayed > 0 and gaps > 0,
          f"[replicas] (c) the faults were not exercised: {out}")
    log(f"[replicas] (c) R=3 under faults: {dropped} records dropped, "
        f"{delayed} delayed, {gaps} gap reconciles "
        f"({out['reconciles']} reconciles); stream {stream_s:.1f} s; "
        f"settle rounds {[round(r['s'], 3) for r in rounds]} s; every "
        f"replica's lookup content equal (hit ratio "
        f"{out['hit_ratio']:.4f})")
    return out


def free_base_port() -> int:
    """A base port whose router (base), worker (base+1, base+2) and
    transport (base+1000, base+1001) ports are free, drawn below the
    kernel's ephemeral range: the phase's own connections and OS-assigned
    listeners take ports meanwhile, and none lands there."""
    import random
    import socket
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(10_000, max(10_001, low - 1002))
        try:
            for p in (base, base + 1, base + 2, base + 1000, base + 1001):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
    raise PhaseError("[replicas] (d) no free port range")


class ServeLauncher:
    """(d): ``python -m repro_torch.launch.serve --mode replica --transport
    socket --replicas 2`` at the reference's defaults (reduced qwen3, dim
    32, hash embedder, dense cache) on this card, in its own process group so
    that nothing it starts outlives the phase."""

    def __init__(self, workdir: Path):
        import os
        self.base = free_base_port()
        self.url = f"http://127.0.0.1:{self.base}"
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.log_path = workdir / "serve.log"
        self.log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "replica", "--transport", "socket", "--replicas", "2",
             "--port", str(self.base)], env=env, stdout=self.log,
            stderr=subprocess.STDOUT, start_new_session=True)

    def tail(self) -> str:
        return self.log_path.read_text()[-3000:]

    def get(self, path: str):
        import urllib.request
        with urllib.request.urlopen(self.url + path, timeout=30.0) as r:
            return json.loads(r.read())

    def post(self, body: dict):
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self.url + "/v1/query", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120.0) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    def run(self) -> dict:
        import signal
        import urllib.error
        while True:
            check(self.proc.poll() is None, f"[replicas] (d) the launcher "
                                            f"exited: {self.tail()}")
            try:
                if self.get("/healthz")["status"] == "serving":
                    break
            except (urllib.error.URLError, OSError, ValueError):
                pass
            check(time.perf_counter() - self.t0 < REPL_SERVE_S,
                  f"[replicas] (d) the workers never came up: {self.tail()}")
            time.sleep(0.25)
        up_s = time.perf_counter() - self.t0
        toks = [11, 12, 13, 14, 15]
        miss = self.post({"tokens": toks, "user": 0, "max_new": 4})
        check(miss[0] == 200 and miss[1].get("X-Cache") == "MISS"
              and miss[1].get("X-Routed-To") == "r0",
              f"[replicas] (d) the first query was not a MISS on r0: "
              f"{miss}")
        t1 = time.perf_counter()
        while True:
            r1 = self.get("/healthz")["replicas"]["r1"]
            if r1.get("replication", {}).get("merged_rows", 0) >= 1:
                break
            check(time.perf_counter() - t1 < 30.0,
                  f"[replicas] (d) r0's delta never reached r1: {r1}")
            time.sleep(0.05)
        cross_s = time.perf_counter() - t1
        hit = self.post({"tokens": toks, "user": 1, "max_new": 4})
        check(hit[0] == 200 and hit[1].get("X-Cache") == "HIT"
              and hit[1].get("X-Routed-To") == "r1",
              f"[replicas] (d) the peer's repeat was not a HIT on r1: {hit}")
        health = self.get("/healthz")
        for name in ("r0", "r1"):
            t = health["replicas"][name]["replication"]["transport"]
            check(t["kind"] == "socket" and len(t["peers"]) == 1,
                  f"[replicas] (d) {name}'s /healthz lacks its transport "
                  f"stats: {t}")
        launches = {}
        for name in ("r0", "r1"):
            worker = self.get_worker(name)
            for k, v in worker["kernel_launches"].items():
                launches[k] = launches.get(k, 0) + v
        t1 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            code = None
        stop_s = time.perf_counter() - t1
        check(code == 0, f"[replicas] (d) SIGTERM: the launcher exited "
                         f"{code}: {self.tail()}")
        return {"up_s": up_s, "cross_s": cross_s, "stop_s": stop_s,
                "miss_tokens": miss[2]["tokens_out"],
                "transport": {n: health["replicas"][n]["replication"][
                    "transport"] for n in ("r0", "r1")},
                "launches": launches}

    def get_worker(self, name: str) -> dict:
        """A worker's own /healthz (its kernel launch counts)."""
        import urllib.request
        port = self.base + 1 + int(name[1:])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30.0) as r:
            return json.loads(r.read())

    def close(self) -> None:
        import os
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        else:
            try:            # the workers share the launcher's group
                os.killpg(self.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        self.log.close()


def replay_serve_calls(torch, np, att_recorders) -> None:
    """(d)'s kernel calls, made again here under the recorders: r0's one
    miss (the launcher's reduced qwen3 from seed 0, the same prompt and
    max_new) on the same engine shape, so each is re-checked at its own
    arguments with the others'. The launcher's workers count their own
    launches; this replay's are not counted."""
    from repro_torch.launch.serve import _init_lm
    from repro_torch.configs.base import get_config
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.scheduler import ContinuousBatchScheduler, \
        Request
    cfg = get_config("qwen3-14b").reduced()
    eng = ModelEngine(_init_lm(cfg, 0, torch.device(DEV)), cfg, n_slots=4,
                      max_len=128, device=DEV)
    sched = ContinuousBatchScheduler(eng)
    sched.submit(Request(rid=0, tokens=np.asarray([11, 12, 13, 14, 15],
                                                  np.int32), max_new=4))
    sched.drain()


def phase_replicas(torch, np, models, recorder, att_recorders,
                   seed: int) -> dict:
    """Phase 8: (a) the HTTP front end over an in-process replica group
    (synced on pallas, isolated, synced on pallas_q8), (b) the in-process
    kill and rejoin, (c) the socket kill and rejoin and the R=3 fault
    drill, (d) the serve launcher's socket mode. K1-K4 launch counters are
    zeroed just before and read just after; the children's launches and
    calls come back in the files they leave, the launcher's workers'
    launches through their /healthz. Every call is noted for the
    re-checks at its own arguments."""
    import os
    import shutil
    from repro_torch.core import semantic_cache as SC
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import layers as L
    workdir = ROOT / "build" / f"replicas-{os.getpid()}"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    # the launcher starts first: its workers come up while (a)-(c) run
    launcher = ServeLauncher(workdir)
    torch.cuda.synchronize()
    zero_topk_launches()
    zero_attention_launches()
    SC.ctk_ops = recorder
    t0 = time.perf_counter()
    walls = {}
    try:
        with recorded_ops(L, att_recorders):
            t = time.perf_counter()
            http = {name: replicas_http(torch, np, models, backend, sync,
                                        seed)
                    for name, backend, sync in (
                        ("synced", "pallas", 1), ("isolated", "pallas", 0),
                        ("q8", "pallas_q8", 1))}
            torch.cuda.synchronize()
            walls["a"] = time.perf_counter() - t
            t = time.perf_counter()
            drill = repl_drill_models(torch, seed)
            kill = replicas_kill_inproc(torch, np, drill, seed, workdir)
            walls["b"] = time.perf_counter() - t
            t = time.perf_counter()
            sock = replicas_kill_socket(torch, np, drill, seed, workdir)
            faults = replicas_socket_faults(torch, np, drill)
            walls["c"] = time.perf_counter() - t
            del drill
            torch.cuda.synchronize()
            n = {**topk_launches(), **attention_launches()}
            t = time.perf_counter()
            serve = launcher.run()
            replay_serve_calls(torch, np, att_recorders)
            walls["d"] = time.perf_counter() - t
    finally:
        SC.ctk_ops = ops
        launcher.close()
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    child_att = set()
    for part in (kill, sock):
        child = part.pop("child")
        for fn, c in child["launches"].items():
            n[fn] += c
        recorder.calls.update(child["calls"])
        child_att.update(child["att_calls"])
    for fn, c in serve["launches"].items():
        n[fn] += c
    check(n["cosine_topk"] > 0 and n["cosine_topk_q8"] > 0
          and n["flash_attention"] > 0 and n["flash_attention_f32"] > 0
          and n["decode_attention"] > 0,
          f"[replicas] a kernel of the phase was never launched: {n}")
    syn, iso, q8 = http["synced"], http["isolated"], http["q8"]
    log(f"[replicas] (a) HTTP front end, 2 replicas at full width and "
        f"depth, {syn['requests']} requests each (distinct prompts embed "
        f"at cosine <= {syn['max_unrelated_cos']:.4f}, theta_R "
        f"{REPL_HTTP_THETA}): synced (pallas) "
        f"{syn['hits']} hits ({syn['pair_hits']}/{REPL_PAIRS} peer repeats "
        f"hit, {syn['merged_rows']} rows merged) in {syn['wall_s']:.1f} s; "
        f"isolated {iso['hits']} hits ({iso['pair_hits']}/{REPL_PAIRS}) in "
        f"{iso['wall_s']:.1f} s; pallas_q8 {q8['hits']} hits in "
        f"{q8['wall_s']:.1f} s, {q8['q8']['patched_rows']} rows patched by "
        f"update_spill_row decide as dense with bit-equal sims "
        f"({q8['q8']['probe_hits']}/{q8['q8']['probe']} probe hits)")
    log(f"[replicas] (d) serve --mode replica --transport socket: up in "
        f"{serve['up_s']:.1f} s, MISS then peer HIT (delta crossed in "
        f"{serve['cross_s']:.3f} s), SIGTERM ended all three in "
        f"{serve['stop_s']:.1f} s; worker launches {serve['launches']}")
    wall = time.perf_counter() - t0
    log(f"[replicas] phase done in {wall:.1f} s (a {walls['a']:.1f} s, b "
        f"{walls['b']:.1f} s, c {walls['c']:.1f} s, d {walls['d']:.1f} s); "
        f"launches {n}")
    return {"http": http, "kill": kill, "socket": sock, "faults": faults,
            "serve": serve, "launches": n, "walls": walls, "wall_s": wall,
            "child_att_calls": child_att}


# ---------------------------------------------------------------------------
# phase 9: shard — the sharded cache plane on virtual shards of the card
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4, 8)
SHARD_BACKENDS = ("dense", "pallas", "pallas_q8")
SHARD_BATCHES = (4, 32)       # (a) alternates these batch sizes
SHARD_ROUNDS = 9              # (a): 9 x (4 + 32) = 324 queries
SHARD_COMMIT_AT = 8           # (a): the refresh commit after this batch
SHARD_SPILL_ROOM = 48         # (a): capacity beyond the served centroids,
                              # so misses evict LRU spill rows before the
                              # refresh and its commit trims the spill
SHARD_MAIN_S = 4              # (b), (c) and the timed K1-local block
SHARD_GW_REQUESTS = 40        # (b): the serve_with_siso stream, whole
SHARD_RESTORE_BATCHES = 12    # (c)
SHARD_PER_SHARD = 16384       # (d): rows per shard held fixed
SHARD_TOTAL = 65536           # (d): the fixed corpus of the lookup times
SHARD_LOOKUP_REPS = 20        # (d)


def shard_mesh(torch, S: int):
    """S virtual shards on the one card (the counterpart of the
    reference's forced host devices)."""
    from repro_torch.launch.mesh import make_cache_mesh
    return make_cache_mesh(S, devices=[torch.device(DEV, 0)] * S)


def shard_siso(torch, np, kept, backend: str, S: int):
    """A SISO with the served SISO's configuration on ``backend`` and S
    shards (1: the single-device path) and SHARD_SPILL_ROOM rows of
    capacity beyond the served centroids, restored from the served SISO's
    state and warm-started."""
    import dataclasses
    from repro_torch.core.siso import SISO
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    served = kept["siso"]
    cfg = dataclasses.replace(
        served.cfg, backend=backend,
        capacity=len(served.cache.centroids) + SHARD_SPILL_ROOM,
        shard=ShardedCacheConfig(n_shards=S, mesh=shard_mesh(torch, S))
        if S > 1 else None)
    s = SISO(cfg, device=DEV)
    s.load_state(copy.deepcopy(kept["state"]))
    s.warm_start()
    return s


def shard_stream(np, kept, seed: int) -> list:
    """(a)'s batches: the served stream's embeddings, exact repeats of
    centroid and spill rows (hits), fresh unit vectors (misses, recorded
    as spill rows with these answers)."""
    rng = np.random.default_rng(seed + 9)
    cache = kept["siso"].cache
    served, cent, spill = (kept["queries"], cache.centroids.vectors,
                           cache.spill.vectors)
    batches = []
    for r in range(SHARD_ROUNDS):
        for B in SHARD_BATCHES:
            q = rng.normal(size=(B, D)).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            kind = rng.integers(0, 4, size=B)
            pick = rng.integers(0, 1 << 30, size=B)
            q[kind == 1] = served[pick[kind == 1] % len(served)]
            q[kind == 2] = cent[pick[kind == 2] % len(cent)]
            q[kind == 3] = spill[pick[kind == 3] % len(spill)]
            ans = rng.normal(size=(B, D)).astype(np.float32)
            batches.append((q, ans))
    return batches


def shard_drive(torch, np, siso, batches, probe) -> dict:
    """(a) on one SISO: each batch through handle_batch, its misses
    recorded (an LRU spill insert each); after SHARD_COMMIT_AT batches the
    refresh cycle is ticked to its end one unit a tick (budget 0, so every
    SISO commits at the same point), the probe looked up between ticks."""
    res, gens, t_commit, victims = [], [], None, 0
    aid = 2_000_000
    for b, (q, ans) in enumerate(batches):
        r = siso.handle_batch(q)
        res.append(r)
        for i in np.flatnonzero(~r.hit):
            c = siso.cache
            victims += 0 < c.spill_capacity <= len(c.spill)
            siso.record_llm_answer(q[i], ans[i], aid)
            aid += 1
        if b == SHARD_COMMIT_AT:
            check(siso.needs_refresh(), "[shard] no refresh came due")
            rebuilds = siso.cache.dev_rebuilds
            while True:
                gens.append(siso.cache.lookup(
                    probe, siso.theta_r, update_counts=False).generation)
                if siso.refresh_tick(budget_s=0.0) is not None:
                    break
            t_commit = len(gens)
            gens.append(siso.cache.lookup(
                probe, siso.theta_r, update_counts=False).generation)
            check(siso.cache.dev_rebuilds == rebuilds,
                  "[shard] the refresh rebuilt the mirror")
    c = siso.cache
    return {"results": res, "gens": gens, "ticks": t_commit,
            "victims": victims,
            "spill_ids": c.spill.answer_id.copy(),
            "spill_last_use": c._spill_last_use.copy(),
            "spill_clock": c._spill_clock,
            "counters": (c.hits, c.misses, c.generation, c.dev_swaps),
            "row_writes": c.dev_row_writes, "rebuilds": c.dev_rebuilds,
            "quant": (c.quant_rescored, c.quant_fallbacks)}


def shard_same(np, a: dict, b: dict, sims: str, ctx: str) -> float:
    """(a)'s equality: every LookupResult field, the generations seen
    through the refresh, LRU victims and spill clocks, counters. ``sims``
    is "bitwise" or "allclose" (within ATOL); returns the largest sim
    difference."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(a["results"], b["results"])):
        for f in ("hit", "entry", "region", "answer_id", "answer"):
            check(np.array_equal(getattr(x, f), getattr(y, f)),
                  f"[shard] {ctx} batch {i}: {f} differs")
        check(x.generation == y.generation,
              f"[shard] {ctx} batch {i}: generation differs")
        d = float(np.abs(x.sim - y.sim).max())
        worst = max(worst, d)
        check(d == 0.0 if sims == "bitwise" else d <= ATOL,
              f"[shard] {ctx} batch {i}: sims differ by {d} ({sims})")
    for k in ("gens", "ticks", "victims", "spill_ids", "spill_last_use",
              "spill_clock", "counters"):
        check(same(np, a[k], b[k]), f"[shard] {ctx}: {k} differs")
    return worst


def shard_plane_equality(torch, np, kept, seed: int) -> dict:
    """(a): S in SHARD_COUNTS on each backend, held against one device's
    exact top-1 (dense): the shard-local top-1 is exact by design (K1's
    early exit off, as in the reference), while one device's pallas
    lookup may stop at a good-enough tile, so it is compared for the
    record only. The pallas shard counts agree with each other bit for
    bit; K1-local's sims against K1's are (e)'s check."""
    batches = shard_stream(np, kept, seed)
    probe = batches[0][0][:4]
    out = {"queries": sum(len(q) for q, _ in batches),
           "batches": len(batches)}
    runs = {}
    for backend in SHARD_BACKENDS:
        for S in (1,) + SHARD_COUNTS:
            t = time.perf_counter()
            siso = shard_siso(torch, np, kept, backend, S)
            runs[backend, S] = shard_drive(torch, np, siso, batches, probe)
            runs[backend, S]["wall_s"] = time.perf_counter() - t
            if backend == "pallas" and S == SHARD_MAIN_S:
                kept["siso_s4"] = siso
            del siso
    exact = runs["dense", 1]
    check(exact["ticks"] > 1 and len(set(exact["gens"])) == 2
          and exact["gens"][-1] == exact["gens"][0] + 1,
          f"[shard] the refresh did not commit mid-stream once: "
          f"{sorted(set(exact['gens']))}")
    hits = sum(int(r.hit.sum()) for r in exact["results"])
    check(hits > 20 and exact["counters"][1] > 20 and exact["victims"] > 0,
          f"[shard] (a) served {hits} hits and evicted {exact['victims']} "
          f"spill rows: too few to mean anything")
    for backend in SHARD_BACKENDS:
        for S in (1,) + SHARD_COUNTS:
            r = runs[backend, S]
            rec = {"wall_s": r["wall_s"], "row_writes": r["row_writes"],
                   "quant": r["quant"]}
            out[f"{backend}/S{S}"] = rec
            if S == 1 and backend != "pallas_q8":
                continue
            check(r["row_writes"] > 0 and r["rebuilds"] == exact["rebuilds"],
                  f"[shard] {backend} S={S}: {r['row_writes']} row writes, "
                  f"{r['rebuilds']} rebuilds (one device: "
                  f"{exact['rebuilds']})")
            # DESIGN.md §15: the int8 plane decides as dense, bit for bit
            rec["max_sim_diff"] = shard_same(
                np, r, exact, "bitwise" if backend == "pallas_q8"
                else "allclose", f"{backend} S={S} against one device")
            if backend == "pallas" and S > SHARD_COUNTS[0]:
                shard_same(np, r, runs["pallas", SHARD_COUNTS[0]], "bitwise",
                           f"pallas S={S} against S={SHARD_COUNTS[0]}")
    # one device's pallas lookups against the exact top-1, for the record:
    # where its early exit stopped before the best row, it names another
    # row above theta (the states part after the first such batch)
    first = next((i for i, (x, y) in enumerate(zip(
        runs["pallas", 1]["results"], exact["results"]))
        if not np.array_equal(x.entry, y.entry)), None)
    if first is not None:
        x, y = runs["pallas", 1]["results"][first], exact["results"][first]
        d = x.entry != y.entry
        check(np.array_equal(x.hit, y.hit) and bool(
              (x.sim[d] <= y.sim[d] + ATOL).all()),
              "[shard] one device's pallas lookup is not a good-enough "
              "answer of the exact one")
    out["pallas_one_device_first_early_exit_batch"] = first
    out.update(hits=hits, misses=exact["counters"][1],
               victims=exact["victims"],
               refresh_ticks=exact["ticks"],
               generations=sorted(set(exact["gens"])))
    worst = {b: max(out[f"{b}/S{S}"]["max_sim_diff"] for S in SHARD_COUNTS)
             for b in SHARD_BACKENDS}
    log(f"[shard] (a) {out['queries']} queries in {len(batches)} batches "
        f"of {SHARD_BATCHES} ({hits} hits, {exact['counters'][1]} misses "
        f"recorded, {exact['victims']} of them over LRU spill victims), "
        f"one refresh committed after batch "
        f"{SHARD_COMMIT_AT} in {exact['ticks']} ticks (generations "
        f"{out['generations']}): S = {SHARD_COUNTS} decide as one device's "
        f"exact top-1 on dense (largest sim difference {worst['dense']:.3g})"
        f", pallas ({worst['pallas']:.3g}; S = 2, 4, 8 bit-equal to each "
        f"other) and pallas_q8 (bitwise as dense); one device's pallas "
        f"first stopped early at batch "
        f"{out['pallas_one_device_first_early_exit_batch']}; walls " +
        ", ".join(f"{b} " + "/".join(
            f"{out[f'{b}/S{S}']['wall_s']:.1f}" for S in (1,) + SHARD_COUNTS)
            for b in SHARD_BACKENDS) + " s (S = 1/2/4/8)")
    return out


def shard_gateway(torch, np, models, kept, S: int,
                  backend: str = "pallas") -> dict:
    """(b) one gateway (S shards, or one device) from ServingConfig over
    the served engine, restored from the SISO's state before the served
    stream; the served stream again. The refresh is left off: its budget
    is wall-clock, so two gateways could commit at different requests."""
    import dataclasses
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.gateway import ServingGateway
    _, _, mcfg, mparams = models
    scfg = ServingConfig.from_siso_config(dataclasses.replace(
        kept["siso"].cfg, backend=backend,
        shard=ShardedCacheConfig(n_shards=S, mesh=shard_mesh(torch, S))
        if S > 1 else None))
    engine = ModelEngine(mparams, mcfg, n_slots=3, max_len=96, device=DEV)
    gw = ServingGateway.from_config(scfg, engine=engine,
                                    embed_fn=kept["embed_fn"],
                                    answer_fn=kept["answer_fn"],
                                    auto_refresh=False)
    gw.frontend.load_state(copy.deepcopy(kept["boot_state"]))
    gw.frontend.warm_start()
    ids = []              # the answer id of each lookup, batch by batch
    handle = gw.frontend.handle_batch

    def recording(*a, **kw):
        res = handle(*a, **kw)
        ids.extend(int(i) for i in res.answer_id)
        return res
    gw.frontend.handle_batch = recording
    stream = kept["stream"][:SHARD_GW_REQUESTS]
    t = time.perf_counter()
    for base in range(0, len(stream), 4):
        gw.submit(served_requests(np, kept["tok"], mcfg,
                                  stream[base:base + 4], base))
    done = sorted(gw.drain(), key=lambda r: r.rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rep = gw.report()
    del engine, gw
    return {"served_by": [r.served_by for r in done],
            "answers": [None if r.answer is None else r.answer.copy()
                        for r in done],
            "answer_ids": ids,
            "outs": [list(r.out) for r in done], "wall_s": wall,
            "report": {k: v for k, v in rep.items()
                       if k not in ("theta_trace", "lam_trace", "lookup")},
            "lookup": rep["lookup"]}


def shard_served(torch, np, models, kept) -> dict:
    """(b): the served stream through a 4-shard pallas gateway and through
    one device: served-by per request as one device's pallas gateway
    (hits do not depend on where its early exit stopped), answers and
    answer ids as one device's exact top-1 (dense)."""
    one = shard_gateway(torch, np, models, kept, 1)
    exact = shard_gateway(torch, np, models, kept, 1, "dense")
    four = shard_gateway(torch, np, models, kept, SHARD_MAIN_S)
    n = len(one["served_by"])
    check(one["report"]["completed"] == four["report"]["completed"]
          == exact["report"]["completed"] == n,
          "[shard] (b) not every request completed")
    check(one["served_by"] == four["served_by"] == exact["served_by"],
          "[shard] (b) served-by differs from one device")
    check(four["answer_ids"] == exact["answer_ids"] and all(
          (a is None and b is None) or np.array_equal(a, b)
          for a, b in zip(exact["answers"], four["answers"])),
          "[shard] (b) answers differ from one device's exact top-1")
    check(one["outs"] == four["outs"] == exact["outs"],
          "[shard] (b) completions differ")
    early = sum(a != b for a, b in zip(one["answer_ids"],
                                       four["answer_ids"]))
    rep = four["report"]
    mem = rep["memory"]
    check(rep["cache_shards"] == SHARD_MAIN_S
          and mem["n_shards"] == SHARD_MAIN_S
          and mem["per_shard_bytes"] * SHARD_MAIN_S
          == mem["device_total_bytes"],
          f"[shard] (b) the report does not show the plane: {rep}")
    for k in ("hits", "misses", "dev_row_writes", "served_cache",
              "served_engine"):
        check(rep[k] == one["report"][k],
              f"[shard] (b) report {k} differs from one device")
    check(rep["served_cache"] > 0 and rep["served_engine"] > 0,
          "[shard] (b) the stream did not use both the cache and engine")
    log(f"[shard] (b) ServingGateway.from_config(sharding=S "
        f"{SHARD_MAIN_S}) over qwen3-14b ({models[2].n_layers} layers): "
        f"{n} requests, {rep['served_cache']} from cache, "
        f"{rep['served_engine']} through the engine, served-by equal one "
        f"device's, answers and ids one device's exact top-1 (one "
        f"device's pallas early exit answered {early} hits from another "
        f"row above theta); cache_shards={rep['cache_shards']}, "
        f"cache_rows_per_shard={rep['cache_rows_per_shard']}, per-shard "
        f"bytes {mem['per_shard_bytes']:,} (one device "
        f"{one['report']['memory']['per_shard_bytes']:,}); lookup p50 "
        f"{four['lookup']['p50_ms']:.3f} ms (one device "
        f"{one['lookup']['p50_ms']:.3f}); wall {four['wall_s']:.1f} s "
        f"(one device {one['wall_s']:.1f})")
    return {"requests": n, "one_device": one["report"],
            "one_device_early_exit_answers": early,
            "sharded": rep, "lookup_p50_ms": four["lookup"]["p50_ms"],
            "lookup_p50_ms_one_device": one["lookup"]["p50_ms"],
            "wall_s": four["wall_s"], "wall_s_one_device": one["wall_s"]}


def shard_restore(torch, np, kept, seed: int, workdir) -> dict:
    """(c): the S=4 cache of (a) snapshotted through the port's
    CheckpointManager, restored onto S=4, S=8 and one device; each serves
    SHARD_RESTORE_BATCHES batches (spill inserts between them) as the
    uninterrupted cache does, element-wise, generation included."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    live = kept.pop("siso_s4").cache
    t = time.perf_counter()
    mgr = CheckpointManager(str(workdir / "ckpt"), keep=1)
    mgr.save(1, {"cache": live.state_dict()})
    _, rec = CheckpointManager(str(workdir / "ckpt"), keep=1) \
        .restore_latest()
    save_s = time.perf_counter() - t
    layout = {k: int(v) for k, v in rec["cache"]["layout"].items()}
    check(layout["n_shards"] == SHARD_MAIN_S,
          f"[shard] (c) snapshot layout {layout}")
    restored = {}
    for S in (SHARD_MAIN_S, 8, 1):
        c = SemanticCache(live.dim, live.answer_dim, live.capacity,
                          backend="pallas", device=DEV,
                          shard=ShardedCacheConfig(
                              n_shards=S, mesh=shard_mesh(torch, S))
                          if S > 1 else None)
        c.load_state(rec["cache"])
        c.rebuild_mirror()
        restored[S] = c
    rng = np.random.default_rng(seed + 19)
    theta = kept["siso"].theta_r
    for b in range(SHARD_RESTORE_BATCHES):
        q = rng.normal(size=(4, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q[0] = live.spill.vectors[b % len(live.spill)]
        q[1] = live.centroids.vectors[(7919 * b) % len(live.centroids)]
        ref = live.lookup(q, theta)
        for S, c in restored.items():
            r = c.lookup(q, theta)
            for f in ("hit", "sim", "entry", "region", "answer_id",
                      "answer"):
                check(np.array_equal(getattr(r, f), getattr(ref, f)),
                      f"[shard] (c) restored S={S} batch {b}: {f} differs")
            check(r.generation == ref.generation,
                  f"[shard] (c) restored S={S} batch {b}: generation")
        a = rng.normal(size=(D,)).astype(np.float32)
        for c in (live, *restored.values()):
            c.insert_spill(q[2], a, answer_id=3_000_000 + b)
    for S, c in restored.items():
        check(np.array_equal(c._spill_last_use, live._spill_last_use),
              f"[shard] (c) restored S={S}: spill clocks differ")
    log(f"[shard] (c) the S={SHARD_MAIN_S} cache snapshotted "
        f"(layout {layout}) and restored onto S={SHARD_MAIN_S}, 8 and one "
        f"device in {save_s:.2f} s: {SHARD_RESTORE_BATCHES} batches "
        f"element-wise equal to the uninterrupted cache (sims bit-equal, "
        f"generation {live.generation})")
    return {"layout": layout, "save_restore_s": save_s,
            "batches": SHARD_RESTORE_BATCHES}


def shard_capacity(torch, np, seed: int) -> dict:
    """(d), bench_shard's measurement 1 at dim 768: SHARD_PER_SHARD rows a
    shard, S = 1, 2, 4, 8; then the batched top-1 lookup (pallas, host
    clock around lookup, which ends in a copy to the host) over a fixed
    SHARD_TOTAL-row corpus split S ways. No speedup is asserted: the
    shards share one card. Bytes a shard are the layout's arithmetic
    (``nbytes_per_shard``); what the card holds is measured beside them
    (``torch.cuda.memory_allocated`` around the build), and grows with S
    here, where every shard is on one card."""
    import gc
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    g = gen(torch, seed + 29)

    def cache(S, n):
        c = SemanticCache(D, D, capacity=n, backend="pallas", device=DEV,
                          shard=ShardedCacheConfig(
                              n_shards=S, mesh=shard_mesh(torch, S))
                          if S > 1 else None)
        v = torch.nn.functional.normalize(
            torch.randn((n, D), generator=g, device=DEV), dim=1)
        v = v.cpu().numpy()
        st = CentroidStore(D, D)
        st.add(v, v, np.ones(n), answer_id=np.arange(n))
        c.set_centroids(st)
        return c, v

    cap = []
    for S in (1,) + SHARD_COUNTS:
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        c, v = cache(S, SHARD_PER_SHARD * S)
        c.lookup(v[:4], 0.9, update_counts=False)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        dev = c._dev
        per = (dev.nbytes_per_shard() if S > 1 else
               c.memory_bytes()["device_total_bytes"])
        cap.append({"n_shards": S, "resident_rows": len(v),
                    "rows_capacity": dev.rows, "per_shard_bytes": per,
                    "card_bytes_held": held})
        del c, v, dev
    check(all(r["resident_rows"] == SHARD_PER_SHARD * r["n_shards"]
              and r["per_shard_bytes"] == cap[0]["per_shard_bytes"]
              for r in cap),
          f"[shard] (d) the layout's bytes a shard are not flat: {cap}")
    check(all(r["card_bytes_held"] >= r["n_shards"] * r["per_shard_bytes"]
              for r in cap),
          f"[shard] (d) the card holds fewer bytes than the shards' "
          f"layout: {cap}")
    lat = []
    rng = np.random.default_rng(seed + 31)
    for S in (1,) + SHARD_COUNTS:
        c, v = cache(S, SHARD_TOTAL)
        row = {"n_shards": S, "total_rows": SHARD_TOTAL}
        for B in SHARD_BATCHES:
            # random queries (no early exit) and one exact copy
            q = rng.normal(size=(B, D)).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            q[0] = v[int(rng.integers(0, SHARD_TOTAL))]
            c.lookup(q, 0.9, update_counts=False)       # warm
            ts = []
            for _ in range(SHARD_LOOKUP_REPS):
                t0 = time.perf_counter()
                r = c.lookup(q, 0.9, update_counts=False)
                ts.append(1e3 * (time.perf_counter() - t0))
            check(bool(r.hit[0]) and not r.hit[1:].any(),
                  f"[shard] (d) S={S}: the copy missed or a random hit")
            row[f"p50_ms_B{B}"] = statistics.median(ts)
        lat.append(row)
        del c, v
    torch.cuda.empty_cache()
    log("[shard] (d) capacity at dim 768, " + f"{SHARD_PER_SHARD:,} rows a "
        "shard: " + "; ".join(
            f"S={r['n_shards']} {r['resident_rows']:,} rows, "
            f"{r['per_shard_bytes']:,} B a shard by the layout, "
            f"{r['card_bytes_held']:,} B held on the card (allocator)"
            for r in cap) + "; capacity across cards not verified (one card)")
    log(f"[shard] (d) lookup over {SHARD_TOTAL:,} rows (pallas, host p50 "
        f"of {SHARD_LOOKUP_REPS}, ms at B = {SHARD_BATCHES}): " + "; ".join(
            f"S={r['n_shards']} " + "/".join(
                f"{r[f'p50_ms_B{B}']:.3f}" for B in SHARD_BATCHES)
            for r in lat))
    return {"capacity": cap, "latency": lat}


def compare_local(torch, ops, ref, x) -> float:
    """K1's shard-local mode against its plain version on one input."""
    kb, kl = ops.cosine_top1_local(x.q, x.rows, x.valid)
    pb, pl = ref.cosine_top1_local_ref(x.q, x.rows, x.valid)
    torch.cuda.synchronize()
    B, n = x.q.shape[0], x.n
    ctx = f"cosine_top1_local B={B} N={n}"
    check(kb.shape == (B,) and kl.shape == (B,) and kl.dtype == torch.int32,
          f"{ctx}: shapes")
    check(torch.equal(kl, pl), f"{ctx}: rows differ")
    fin = torch.isfinite(pb)
    check(torch.equal(fin, torch.isfinite(kb)), f"{ctx}: finiteness")
    e = float((kb[fin] - pb[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(e <= ATOL, f"{ctx}: max abs err {e}")
    if not bool(x.valid.any()):
        check(not bool(fin.any()) and bool((kl == 0).all()),
              f"{ctx}: an all-invalid block must give -inf at row 0")
    return e


def shard_kernel_checks(torch, np, calls: set, kept, seed: int) -> dict:
    """(e): K1-local against its plain version at every (B, N) the phase
    launched, at N = 32 and 33 and on an all-invalid block; then timed at
    the main shard shape (block 0 of the S=4 served mirror, B = 4)."""
    from repro_torch.kernels.cosine_topk import ops, ref
    shapes = {(B, n) for fn, B, n, *_ in calls if fn == "cosine_top1_local"}
    check(shapes, "[shard] (e) K1-local was never called")
    err = 0.0
    for B, n in sorted(shapes | {(4, 32), (4, 33), (32, 33)}):
        x = Inputs(torch, ops, B, seed + 3 * B + n, n)
        err = max(err, compare_local(torch, ops, ref, x))
    x = Inputs(torch, ops, 4, seed + 5, 4096)
    x.valid = torch.zeros_like(x.valid)
    compare_local(torch, ops, ref, x)
    log(f"[shard] (e) K1-local agrees with its plain version at "
        f"{len(shapes)} launched shapes (B, N) "
        f"{sorted(shapes)}, at N = 32 and 33 and on an all-invalid block "
        f"(max abs err {err:.3g})")
    # K1's per-row arithmetic does not depend on N or on the row's tile:
    # each shard block's K1-local result is K1's over the whole mirror
    # with only that shard's rows valid, bit for bit (so sharded pallas
    # sims equal one device's wherever both scan every row)
    dev = kept["s4_dev"]
    S, pad = dev.n_shards, dev.pad
    whole = torch.empty((S * pad, D), device=DEV)
    for s in range(S):
        whole[s::S] = dev.mat[s]
    for B in SHARD_BATCHES:
        q = torch.tensor(kept["queries"][:B], device=DEV)
        for s in range(S):
            only = torch.zeros(S * pad, dtype=torch.bool, device=DEV)
            only[s::S] = dev.valid[s]
            fv, fi = ops.cosine_topk(q, whole, k=1, valid=only)
            kb, kl = ops.cosine_top1_local(q, dev.mat[s], dev.valid[s])
            check(torch.equal(kb, fv[:, 0])
                  and torch.equal(kl.long() * S + s, fi[:, 0].long()),
                  f"[shard] (e) K1-local on shard {s} of {S} (B={B}) is "
                  f"not K1 over the whole mirror bit for bit")
    del whole
    log(f"[shard] (e) K1-local on each of the {S} shard blocks ({pad:,} "
        f"rows) equals K1 over the whole {S * pad:,}-row mirror with only "
        f"that shard's rows valid, bit for bit, at B = {SHARD_BATCHES}")
    # timed at the main shard shape, B = 4 on the served mirror's S=4
    # blocks in turn, as a lookup reads them: the four blocks' valid rows
    # (about 112 MB) exceed the 50 MB L2, where one block alone would stay
    # in it from call to call
    q = torch.tensor(kept["queries"][:4], device=DEV)
    need = sum(int(v.sum()) for v in dev.valid) / S
    neg = torch.tensor(float("-inf"), device=DEV)
    turn = [0]

    def rotating(f):
        def call():
            s = turn[0] % S
            turn[0] += 1
            return f(dev.mat[s], dev.valid[s])
        return call
    kern = rotating(lambda m, v: ops.cosine_top1_local(q, m, v))
    plain = rotating(lambda m, v: ref.cosine_top1_local_ref(q, m, v))
    lib = rotating(lambda m, v: torch.max(torch.where(v[None], q @ m.T, neg),
                                          dim=1))
    b_ms, b_by = bound("cosine_topk", 4, 1, need, pad)
    rec = {"B": 4, "N": pad, "rows_needed": need,
           "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
           "library_ms": cuda_ms(torch, lib), "bound_ms": b_ms,
           "bound_by": b_by}
    rec.update(topk_device_ms(torch, kern, "cosine_top1_local", iters=20))
    rec.update(library_device_ms(torch, lib))
    dms = rec["device_ms"]
    log(f"[shard] (e) K1-local B=4 on the {S} {pad:,}-row shard blocks in "
        f"turn ({need:,.0f} valid rows each on average): kernel "
        f"{rec['ms']:.4f} ms, device "
        f"{'not measured' if dms is None else f'{dms:.4f} ms'} "
        f"(records {rec.get('device_records')} of 20 calls), plain "
        f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms "
        f"(device {rec['library_device_ms']}, records "
        f"{rec['library_device_records']} of 10 calls), bound {b_ms:.4f} ms ({b_by}"
        f", {b_ms / rec['ms']:.3f} of the events time)")
    return {"max_abs_err": err, "shapes": sorted(shapes), "timing": rec}


def phase_shard(torch, np, models, kept, recorder, att_recorders,
                seed: int) -> dict:
    """Phase 9: the sharded cache plane (DESIGN.md §11) at the main path's
    size on S virtual shards of the card: (a) plane equality, (b) the
    served stream through a sharded gateway, (c) restore across shard
    counts, (d) capacity scaling, (e) K1-local's checks and times. The
    K1, K1-local, K2, K3 and K4 launch counters are zeroed just before
    (a)-(c) and read just after; every call is noted for the re-checks."""
    import os
    import shutil
    from repro_torch.core import semantic_cache as SC
    from repro_torch.distributed import cache_plane as CP
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.models import layers as L
    workdir = ROOT / "build" / f"shard-{os.getpid()}"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    kept["state"] = kept["siso"].state_dict()
    t0 = time.perf_counter()
    walls = {}
    torch.cuda.synchronize()
    zero_topk_launches()
    zero_attention_launches()
    SC.ctk_ops = CP.ctk_ops = recorder
    try:
        with recorded_ops(L, att_recorders):
            t = time.perf_counter()
            plane = shard_plane_equality(torch, np, kept, seed)
            kept["s4_dev"] = kept["siso_s4"].cache._dev
            walls["a"] = time.perf_counter() - t
            t = time.perf_counter()
            served = shard_served(torch, np, models, kept)
            walls["b"] = time.perf_counter() - t
            t = time.perf_counter()
            restore = shard_restore(torch, np, kept, seed, workdir)
            walls["c"] = time.perf_counter() - t
            torch.cuda.synchronize()
            n = {**topk_launches(), **attention_launches()}
    finally:
        SC.ctk_ops = CP.ctk_ops = ops
        shutil.rmtree(workdir, ignore_errors=True)
    check(n["cosine_top1_local"] > 0 and n["cosine_topk"] > 0
          and n["cosine_topk_q8"] > 0 and n["flash_attention"] > 0
          and n["flash_attention_f32"] > 0 and n["decode_attention"] > 0,
          f"[shard] a kernel of the phase was never launched: {n}")
    t = time.perf_counter()
    capacity = shard_capacity(torch, np, seed)
    walls["d"] = time.perf_counter() - t
    t = time.perf_counter()
    kern = shard_kernel_checks(torch, np, recorder.calls, kept, seed)
    walls["e"] = time.perf_counter() - t
    for k in ("s4_dev", "state", "boot_state"):
        kept.pop(k)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[shard] phase done in {wall:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + f"); launches {n}")
    return {"plane": plane, "served": served, "restore": restore,
            "capacity": capacity, "kernel": kern, "launches": n,
            "walls": walls, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 10: zoo, the MoE + sliding-window kind and the VLM prefix-LM
# ---------------------------------------------------------------------------

ZOO_RTOL = 0.05     # as ENGINE_RTOL: the largest |kernel - plain| logit
                    # over the largest |plain| logit, bf16 activations
                    # through 8 (mixtral) or 18 (paligemma) layers of random
                    # weights; each K3/K4 call is also held against its
                    # plain version at its own arguments. A planted fault
                    # must exceed it: the window dropped from mixtral's
                    # prefill (the last 512 of 4,608 rows see 512 more
                    # keys), paligemma's prefix made causal
MIXTRAL_LAYERS = 8  # of 32: 32 layers in bf16 are 93.4 GB, more than the
                    # card's 80 GB; widths, experts and window unchanged
MIXTRAL_PROMPT = 4608       # past the 4,096-token window: the ring wraps
MIXTRAL_SLOTS, MIXTRAL_MAX, MIXTRAL_STEPS = 4, 8192, 16     # Lc = 4,096
PALI_B, PALI_TEXT, PALI_STEPS = 2, 256, 8    # after 256 patch embeddings
# the dense kinds never served elsewhere, at full size: qwen2.5-14b (48
# layers, qkv biases, 29.5 GB in bf16) and command-r-35b (40 layers, 8192
# wide, tied 256,000-row embedding, 60.6 GB); four prompts, 16 steps
DENSE_ARCHS = ("qwen2.5-14b", "command-r-35b")
DENSE_SLOTS, DENSE_PROMPT, DENSE_STEPS = 4, 4096, 16
DENSE_MAX = DENSE_PROMPT + 256      # command-r's bf16 cache: 2.9 GB


class routing:
    """Within the block, every MoE layer's gating notes its expert indices
    in ``idx`` (one entry a call), or takes them from ``force`` (a run's
    notes) with the gates renormalised over the forced experts' own
    probabilities: the plain run held with the kernel run's routing."""

    def __init__(self, L, force=None):
        self.L, self.force, self.idx = L, force, []

    def __enter__(self):
        real = self.saved = self.L.moe_gating

        def gating(logits, top_k, renormalize=True):
            gates, idx, aux = real(logits, top_k, renormalize)
            if self.force is not None:
                idx = self.force[len(self.idx)]
                gates = logits.float().softmax(dim=-1).gather(-1, idx)
                gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(
                    1e-9)
            self.idx.append(idx)
            return gates, idx, aux
        self.L.moe_gating = gating
        return self

    def __exit__(self, *exc):
        self.L.moe_gating = self.saved


def flip_shares(a: list, b: list) -> list:
    """Per MoE call (one a layer), the share of tokens whose top-k expert
    set differs between two runs' notes."""
    return [float((x.sort(dim=-1).values != y.sort(dim=-1).values)
                  .any(dim=-1).float().mean()) for x, y in zip(a, b)]


def zoo_trace(torch, L, fn, n: int) -> dict:
    """``fn`` (``n`` repeats of the work) under torch.profiler, each MoE
    dispatch in a ``zoo::moe`` range and its expert products
    (``layers._experts``) in ``zoo::experts``: per repeat, the device's
    busy ms, K4's (``flash_bf16``) and K3's (``da::decode``) ms, the MoE's
    device ms and its dispatch's (the MoE's kernels other than the expert
    products: routing, ranking, scatter, gather, combine). Empty where
    the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function
    real_moe, real_experts = L._moe_dispatch, L._experts

    def moe(*a, **kw):
        with record_function("zoo::moe"):
            return real_moe(*a, **kw)

    def experts(*a, **kw):
        with record_function("zoo::experts"):
            return real_experts(*a, **kw)
    torch.cuda.synchronize()
    L._moe_dispatch, L._experts = moe, experts
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        L._moe_dispatch, L._experts = real_moe, real_experts
    tr = device_summary(prof, n)
    if not tr:
        return {}
    by_name = tr.pop("by_name_ms")
    out = {"busy_ms": tr["busy_ms"], "device_events": tr["device_events"],
           "k4_ms": sum(t for k, t in by_name.items() if "flash_bf16" in k),
           "k3_ms": sum(t for k, t in by_name.items() if "da::decode" in k),
           "top_kernels_ms": tr["top_kernels_ms"]}

    # the host-side ranges: their kernels and their children's, each once
    # (the profiler's device-side copy of a range is a span, gaps
    # included, and is left out)
    ranges: dict = {}
    for e in prof.events():
        if e.name.startswith("zoo::") and str(e.device_type).endswith("CPU"):
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total
    if "zoo::moe" in ranges:       # None: the ranges hold no device time
        moe = ranges["zoo::moe"] / 1e3 / n
        out["moe_ms"] = moe or None
        out["moe_dispatch_ms"] = (
            moe - ranges.get("zoo::experts", 0.0) / 1e3 / n) if moe else None
    for key in ("k4_ms", "k3_ms", "moe_ms", "moe_dispatch_ms"):
        if out.get(key) is not None:
            out[key.replace("_ms", "_share")] = out[key] / out["busy_ms"]
    return out


def log_zoo_trace(what: str, tr: dict, tag: str = "zoo") -> None:
    if not tr:
        log(f"[{tag}] {what}: the profiler recorded no device activity; the "
            f"split is not measured")
        return
    parts = [f"device busy {tr['busy_ms']:.3f} ms ({tr['device_events']} "
             f"device events)"]
    for key, name in (("k4", "K4"), ("k3", "K3"), ("moe", "MoE"),
                      ("moe_dispatch", "MoE dispatch")):
        if tr.get(f"{key}_share") is not None and tr[f"{key}_ms"]:
            parts.append(f"{name} {tr[f'{key}_ms']:.3f} ms "
                         f"({tr[f'{key}_share']:.3f})")
        elif f"{key}_ms" in tr and key.startswith("moe"):
            parts.append(f"{name} not measured")
    log(f"[{tag}] {what}: " + ", ".join(parts) + "; most device time: "
        + "; ".join(f"{n} {t:.3f} ms" for n, t in tr["top_kernels_ms"]))


def zoo_rel(torch, cfg, a, b) -> float:
    """``rel_diff`` over the vocabulary's logits: the padded columns hold
    the dtype's lowest value in both and would be the largest."""
    V = cfg.vocab_size
    return rel_diff(torch, a[..., :V], b[..., :V])


def zoo_held(torch, L, cfg, what: str, forward, kernel, kernel_notes, plain,
             plain_notes, flash=None) -> dict:
    """The kernel run's logits held against the plain layers' at
    ZOO_RTOL. A routing flip (a token's expert set differing between the
    two runs) can move the logits past it on its own; then ``forward``
    runs the plain side again with the kernel run's routing forced (and
    ``flash`` as its prefill attention, as in the plain run), and that is
    held."""
    rel = zoo_rel(torch, cfg, kernel, plain)
    flips = flip_shares(kernel_notes, plain_notes)
    held, forced = rel, None
    if rel > ZOO_RTOL and any(flips):
        with routing(L, force=kernel_notes), swap_attention(L, flash=flash):
            held = forced = zoo_rel(torch, cfg, kernel, forward())
    check(held <= ZOO_RTOL, f"[zoo] {what}: kernel vs plain logits differ "
                            f"by {held:.4g} of the largest logit, over "
                            f"{ZOO_RTOL} (routing flips per layer {flips})")
    return {"rel_diff": rel, "rel_diff_forced_routing": forced,
            "rel_diff_held": held, "routing_flip_share": flips}


def zoo_mixtral(torch, np, L, lm, mparams, mcfg, att_recorders, seed: int,
                kv_dtype: str) -> dict:
    """Four 4,608-token prompts prefilled into a 4-slot engine (K4 with the
    window on every layer; the ring of 4,096 slots wraps), then 16 batched
    decode steps (K3 over the ring). The first prefill's last-position
    logits and the first decode step's are held against the plain layers
    (``zoo_held``); with the bf16 cache, the window dropped from the plain
    prefill must move them past ZOO_RTOL. Launch counters and recorders
    as in engine-long."""
    from repro_torch.serving.engine import ModelEngine
    cfg = mcfg.replace(kv_dtype=kv_dtype)
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, MIXTRAL_PROMPT)
               for _ in range(MIXTRAL_SLOTS)]
    first = {"tokens": torch.tensor(prompts[0][None], device=DEV)}
    rec: dict = {"kv_dtype": kv_dtype}
    with torch.inference_mode():
        def prefill1():
            return lm.prefill(mparams, cfg, first, lm.init_cache(
                cfg, 1, MIXTRAL_PROMPT, device=DEV))[0]
        with routing(L) as kr:
            kl = prefill1()
        with routing(L) as pr, swap_attention(L):
            pl = prefill1()
        rec["prefill"] = zoo_held(torch, L, cfg,
                                  f"mixtral {kv_dtype} prefill", prefill1,
                                  kl, kr.idx, pl, pr.idx)
        if kv_dtype == "bfloat16":
            def window_dropped(q, k, v, **kw):
                check(kw == {"causal": True, "window": cfg.window,
                             "prefix_len": 0},
                      f"[zoo] mixtral prefill attention called with {kw}")
                return L.flash_attention_plain(q, k, v, causal=True)
            with routing(L, force=pr.idx), swap_attention(
                    L, flash=window_dropped):
                fl = prefill1()
            rec["rel_diff_planted_fault"] = f = zoo_rel(torch, cfg, fl, pl)
            check(f > ZOO_RTOL, f"[zoo] mixtral: the window dropped from the"
                                f" prefill moves the logits by {f:.4g} of "
                                f"the largest, within ZOO_RTOL {ZOO_RTOL}")
            log(f"[zoo] mixtral planted fault (the window dropped from the "
                f"prefill, the plain run's routing forced): logits move by "
                f"{f:.4g} of the largest (limit {ZOO_RTOL})")
            del fl
        del kl, pl
    torch.cuda.empty_cache()
    eng = ModelEngine(mparams, cfg, n_slots=MIXTRAL_SLOTS,
                      max_len=MIXTRAL_MAX, device=DEV)
    check(eng.cache["k"].shape[2] == cfg.window, "[zoo] ring length")
    torch.cuda.synchronize()
    zero_attention_launches()
    prefill_ms, toks = [], []
    with recorded_ops(L, att_recorders):
        for s, p in enumerate(prompts):
            t0 = time.perf_counter()
            toks.append(eng.prefill_into(s, p))
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
    launches = attention_launches()
    toks = np.asarray(toks, np.int64)
    with torch.inference_mode():
        pos = torch.tensor(eng.pos.astype(np.int64), device=DEV)
        tok = torch.tensor(toks, device=DEV)[:, None]

        def decode1():
            return lm.decode_step(mparams, cfg, tok, eng.cache, pos,
                                  kv_len=pos + 1,
                                  moe_groups=MIXTRAL_SLOTS)[0]
        with routing(L) as kr:
            kd = decode1()
        with routing(L) as pr, swap_attention(L):
            pd = decode1()
        rec["decode"] = zoo_held(torch, L, cfg,
                                 f"mixtral {kv_dtype} decode", decode1, kd,
                                 kr.idx, pd, pr.idx)
    torch.cuda.synchronize()
    zero_attention_launches()
    decode_ms = []
    with recorded_ops(L, att_recorders):
        for _ in range(MIXTRAL_STEPS):
            t0 = time.perf_counter()
            toks = eng.decode_active(toks)
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    for k, v in attention_launches().items():
        launches[k] += v
    k3 = "decode_attention_int8" if kv_dtype == "int8" else "decode_attention"
    check(launches["flash_attention"] == MIXTRAL_SLOTS * n
          and launches[k3] == MIXTRAL_STEPS * n,
          f"[zoo] mixtral {kv_dtype}: launches {launches}, expected "
          f"{MIXTRAL_SLOTS * n} K4 and {MIXTRAL_STEPS * n} {k3}")
    check(all(0 <= t < cfg.vocab_size for t in toks),
          f"[zoo] mixtral {kv_dtype}: bad tokens {toks}")
    rec.update(launches=launches, prefill_ms=prefill_ms, decode_ms=decode_ms,
               prefill_ms_median=statistics.median(prefill_ms),
               decode_ms_median=statistics.median(decode_ms),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"[zoo] mixtral {kv_dtype} KV: {MIXTRAL_SLOTS} prompts of "
        f"{MIXTRAL_PROMPT} tokens over window {cfg.window}, prefill "
        f"{rec['prefill_ms_median']:.1f} ms per prompt (median; "
        f"{', '.join(f'{t:.1f}' for t in prefill_ms)}), {MIXTRAL_STEPS} "
        f"decode steps {rec['decode_ms_median']:.2f} ms per step (median); "
        f"kernel vs plain logits {rec['prefill']['rel_diff']:.4g} (prefill)"
        f" and {rec['decode']['rel_diff']:.4g} (decode) of the largest "
        f"(held {rec['prefill']['rel_diff_held']:.4g} / "
        f"{rec['decode']['rel_diff_held']:.4g}, limit {ZOO_RTOL}); routing "
        f"flips per layer: prefill "
        f"{[round(x, 4) for x in rec['prefill']['routing_flip_share']]}, "
        f"decode {[round(x, 4) for x in rec['decode']['routing_flip_share']]}"
        f"; launches {launches}; peak memory "
        f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")
    rec["decode_trace"] = tr = zoo_trace(
        torch, L, lambda: [eng.decode_active(toks) for _ in range(2)], 2)
    log_zoo_trace(f"mixtral {kv_dtype} KV, profiled decode (per step of 2)",
                  tr)
    if tr:
        tr["idle_share"] = 1 - tr["busy_ms"] / rec["decode_ms_median"]
        log(f"[zoo] mixtral {kv_dtype} KV: idle share {tr['idle_share']:.3f}"
            f" of the unprofiled median step")
    rec["prefill_trace"] = tr = zoo_trace(
        torch, L, lambda: eng.prefill_into(0, prompts[0]), 1)
    log_zoo_trace(f"mixtral {kv_dtype} KV, profiled prefill of "
                  f"{MIXTRAL_PROMPT} tokens", tr)
    del eng
    torch.cuda.empty_cache()
    return rec


def zoo_dense(torch, np, L, lm, arch: str, att_recorders, seed: int
              ) -> dict:
    """``arch`` at full size through ``ModelEngine(n_slots=DENSE_SLOTS,
    max_len=DENSE_MAX)``, with the bf16 and the int8 KV cache: four
    DENSE_PROMPT-token prompts prefilled (K4 on every layer), then
    DENSE_STEPS batched decode steps (K3). The first prefill's
    last-position logits and the first decode step's are held against the
    plain layers at ZOO_RTOL (the plain prefill attention PLAIN_ROWS query
    rows at a time, ``plain_rows``: command-r's 64 heads of f32 scores at
    4,096 tokens would take 13 GB beside its 60.6 GB of weights). Every
    K3/K4 call is noted for the re-checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.engine import ModelEngine
    full = get_config(arch)
    t0 = time.perf_counter()
    params = lm.init_params(gen(torch, seed + 22), full, device=DEV)
    torch.cuda.synchronize()
    n = full.n_layers
    log(f"[zoo] {arch} at full size: {n} layers, d={full.d_model} heads="
        f"{full.n_heads}/{full.n_kv_heads} d_head={full.head_dim} d_ff="
        f"{full.d_ff} vocab={full.vocab_size} (tied "
        f"{full.tie_embeddings}, qkv bias {full.qkv_bias}): "
        f"{lm.n_params(params) * 2 / 1e9:.1f} GB in bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 12)
    prompts = [rng.integers(0, full.vocab_size, DENSE_PROMPT)
               for _ in range(DENSE_SLOTS)]
    first = {"tokens": torch.tensor(prompts[0][None], device=DEV)}
    out: dict = {"n_params": lm.n_params(params)}
    launches = dict.fromkeys(ATT_KEYS, 0)
    for kv_dtype in ("bfloat16", "int8"):
        cfg = full.replace(kv_dtype=kv_dtype)
        torch.cuda.reset_peak_memory_stats()
        rec: dict = {"kv_dtype": kv_dtype}
        with torch.inference_mode():
            def prefill1():
                return lm.prefill(params, cfg, first, lm.init_cache(
                    cfg, 1, DENSE_PROMPT, device=DEV))[0]
            kl = prefill1()
            with swap_attention(L, flash=plain_rows(torch, L)):
                pl = prefill1()
            rec["prefill_rel_diff"] = r = zoo_rel(torch, cfg, kl, pl)
            check(r <= ZOO_RTOL, f"[zoo] {arch} {kv_dtype} prefill: kernel "
                                 f"vs plain logits {r:.4g} of the largest, "
                                 f"over {ZOO_RTOL}")
            del kl, pl
        torch.cuda.empty_cache()
        eng = ModelEngine(params, cfg, n_slots=DENSE_SLOTS,
                          max_len=DENSE_MAX, device=DEV)
        torch.cuda.synchronize()
        zero_attention_launches()
        prefill_ms, toks = [], []
        with recorded_ops(L, att_recorders):
            for s, p in enumerate(prompts):
                t = time.perf_counter()
                toks.append(eng.prefill_into(s, p))
                torch.cuda.synchronize()
                prefill_ms.append(1e3 * (time.perf_counter() - t))
        got = attention_launches()
        toks = np.asarray(toks, np.int64)
        with torch.inference_mode():
            pos = torch.tensor(eng.pos.astype(np.int64), device=DEV)
            tok = torch.tensor(toks, device=DEV)[:, None]

            def decode1():
                return lm.decode_step(params, cfg, tok, eng.cache, pos,
                                      kv_len=pos + 1)[0]
            kd = decode1()
            with swap_attention(L):
                pd = decode1()
            rec["decode_rel_diff"] = r = zoo_rel(torch, cfg, kd, pd)
            check(r <= ZOO_RTOL, f"[zoo] {arch} {kv_dtype} decode: kernel "
                                 f"vs plain logits {r:.4g} of the largest, "
                                 f"over {ZOO_RTOL}")
            del kd, pd
        torch.cuda.synchronize()
        zero_attention_launches()
        decode_ms = []
        with recorded_ops(L, att_recorders):
            for _ in range(DENSE_STEPS):
                t = time.perf_counter()
                toks = eng.decode_active(toks)
                decode_ms.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
        for k, v in attention_launches().items():
            got[k] += v
        for k, v in got.items():
            launches[k] += v
        k3 = "decode_attention_int8" if kv_dtype == "int8" else \
            "decode_attention"
        check(got["flash_attention"] == DENSE_SLOTS * n
              and got[k3] == DENSE_STEPS * n,
              f"[zoo] {arch} {kv_dtype}: launches {got}, expected "
              f"{DENSE_SLOTS * n} K4 and {DENSE_STEPS * n} {k3}")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"[zoo] {arch} {kv_dtype}: bad tokens {toks}")
        rec.update(launches=got, prefill_ms=prefill_ms, decode_ms=decode_ms,
                   prefill_ms_median=statistics.median(prefill_ms),
                   decode_ms_median=statistics.median(decode_ms),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[zoo] {arch} {kv_dtype} KV: {DENSE_SLOTS} prompts of "
            f"{DENSE_PROMPT} tokens, prefill {rec['prefill_ms_median']:.1f} "
            f"ms per prompt (median; "
            f"{', '.join(f'{t:.1f}' for t in prefill_ms)}), {DENSE_STEPS} "
            f"decode steps {rec['decode_ms_median']:.2f} ms per step "
            f"(median); kernel vs plain logits {rec['prefill_rel_diff']:.4g}"
            f" (prefill) and {rec['decode_rel_diff']:.4g} (decode) of the "
            f"largest (limit {ZOO_RTOL}); launches {got}; peak memory "
            f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")
        out[kv_dtype] = rec
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    return out


def zoo_paligemma(torch, np, L, lm, att_recorders, seed: int) -> dict:
    """paligemma-3b at full size: B = 2 of 256 seeded patch embeddings and
    256 text tokens through ``lm.prefill`` (K4: prefix 256, Dh 256, one kv
    head), then 8 greedy ``decode_step``s (K3: Dh 256, 8 query heads a kv
    head). The prefill's and the first step's logits are held against the
    plain layers; the prefix made causal must move them past ZOO_RTOL."""
    from repro_torch.configs.base import get_config
    cfg = get_config("paligemma-3b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(gen(torch, seed + 21), cfg, device=DEV)
    torch.cuda.synchronize()
    log(f"[zoo] {cfg.name} d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_head={cfg.head_dim} d_ff={cfg.d_ff} (gated "
        f"{cfg.act}) vocab={cfg.vocab_size} layers={cfg.n_layers} prefix="
        f"{cfg.prefix_len} bf16, tied embeddings: "
        f"{lm.n_params(params) / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 22)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (PALI_B, PALI_TEXT)), device=DEV),
        "patch_embed": torch.randn(
            (PALI_B, cfg.prefix_len, cfg.d_model), generator=gen(
                torch, seed + 23), device=DEV).to(torch.bfloat16)}
    Lx = cfg.prefix_len + PALI_TEXT
    max_len = Lx + PALI_STEPS + 2           # 2 more steps traced

    def new_cache():
        return lm.init_cache(cfg, PALI_B, max_len, device=DEV)
    rec: dict = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        zero_attention_launches()
        with recorded_ops(L, att_recorders):
            t0 = time.perf_counter()
            kl, cache = lm.prefill(params, cfg, batch, new_cache())
            torch.cuda.synchronize()
            rec["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            start = {k: v.clone() for k, v in cache.items()}
            nxt0 = nxt = torch.argmax(kl, dim=-1)[:, None]
            decode_ms = []
            for step in range(PALI_STEPS):
                t0 = time.perf_counter()
                d, cache = lm.decode_step(params, cfg, nxt, cache, Lx + step)
                nxt = torch.argmax(d, dim=-1)[:, None]
                torch.cuda.synchronize()
                decode_ms.append(1e3 * (time.perf_counter() - t0))
                if step == 0:
                    kd = d
        launches = attention_launches()
        n = cfg.n_layers
        check(launches["flash_attention"] == n
              and launches["decode_attention"] == PALI_STEPS * n,
              f"[zoo] paligemma: launches {launches}, expected {n} K4 and "
              f"{PALI_STEPS * n} K3")
        with swap_attention(L):
            pl, _ = lm.prefill(params, cfg, batch, new_cache())
            pd, _ = lm.decode_step(params, cfg, nxt0, start, Lx)

        def causal_prefix(q, k, v, **kw):
            check(kw == {"causal": True, "window": None,
                         "prefix_len": cfg.prefix_len},
                  f"[zoo] paligemma prefill attention called with {kw}")
            return L.flash_attention_plain(q, k, v, causal=True)
        with swap_attention(L, flash=causal_prefix):
            fl, _ = lm.prefill(params, cfg, batch, new_cache())
        rec["rel_diff_prefill"] = rp = zoo_rel(torch, cfg, kl, pl)
        rec["rel_diff_decode"] = rd = zoo_rel(torch, cfg, kd, pd)
        rec["rel_diff_planted_fault"] = f = zoo_rel(torch, cfg, fl, pl)
        check(rp <= ZOO_RTOL and rd <= ZOO_RTOL,
              f"[zoo] paligemma: kernel vs plain logits differ by {rp:.4g} "
              f"(prefill) / {rd:.4g} (decode) of the largest, over "
              f"{ZOO_RTOL}")
        check(f > ZOO_RTOL, f"[zoo] paligemma: the prefix made causal moves "
                            f"the logits by {f:.4g} of the largest, within "
                            f"ZOO_RTOL {ZOO_RTOL}")
        del pl, pd, fl, start
        rec.update(launches=launches, decode_ms=decode_ms,
                   decode_ms_median=statistics.median(decode_ms),
                   tokens=nxt[:, 0].tolist(),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[zoo] paligemma: B={PALI_B}, {cfg.prefix_len} patches + "
            f"{PALI_TEXT} text tokens, prefill {rec['prefill_ms']:.1f} ms, "
            f"{PALI_STEPS} decode steps {rec['decode_ms_median']:.2f} ms per "
            f"step (median); kernel vs plain logits {rp:.4g} (prefill) and "
            f"{rd:.4g} (decode) of the largest (limit {ZOO_RTOL}); planted "
            f"fault (the prefix made causal) {f:.4g}; launches {launches}; "
            f"peak memory {rec['max_memory_allocated'] / 2**30:.1f} GiB")
        pos = [Lx + PALI_STEPS]

        def two_steps():
            nonlocal cache, nxt
            for _ in range(2):
                d, cache = lm.decode_step(params, cfg, nxt, cache, pos[0])
                nxt = torch.argmax(d, dim=-1)[:, None]
                pos[0] += 1
        rec["decode_trace"] = tr = zoo_trace(torch, L, two_steps, 2)
        log_zoo_trace("paligemma, profiled decode (per step of 2)", tr)
        if tr:
            tr["idle_share"] = 1 - tr["busy_ms"] / rec["decode_ms_median"]
        rec["prefill_trace"] = tr = zoo_trace(
            torch, L, lambda: lm.prefill(params, cfg, batch, new_cache()), 1)
        log_zoo_trace("paligemma, profiled prefill", tr)
    del params, cache
    torch.cuda.empty_cache()
    return rec


def phase_zoo(torch, np, att_recorders, seed: int) -> dict:
    """Phase 10: mixtral-8x7b (MoE + sliding window) at full width cut to
    MIXTRAL_LAYERS layers through ModelEngine, bf16 and int8 KV, then
    paligemma-3b (the VLM prefix-LM) at full size through lm.prefill /
    decode_step. Every K3/K4 call is noted for the re-checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L, lm
    t0 = time.perf_counter()
    full = get_config("mixtral-8x7b")
    mcfg = full.replace(n_layers=MIXTRAL_LAYERS)
    t = time.perf_counter()
    mparams = lm.init_params(gen(torch, seed + 20), mcfg, device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(x.numel() * x.element_size()
                 for x in (mparams["embed"], mparams["lm_head"]))
    layer_bytes = (lm.n_params(mparams["blocks"][0]) * 2)
    log(f"[zoo] depth cut: {full.name} at {MIXTRAL_LAYERS} of "
        f"{full.n_layers} layers ({full.n_layers} in bf16: "
        f"{(nbytes + full.n_layers * layer_bytes) / 1e9:.1f} GB, over the "
        f"card's 80 GB); widths unchanged: d={mcfg.d_model} heads="
        f"{mcfg.n_heads}/{mcfg.n_kv_heads} d_head={mcfg.head_dim} "
        f"{mcfg.n_experts} experts top-{mcfg.top_k} d_ff={mcfg.d_ff_expert} "
        f"window={mcfg.window} vocab={mcfg.vocab_size}: "
        f"{layer_bytes / 1e9:.2f} GB a layer, "
        f"{lm.n_params(mparams) * 2 / 1e9:.1f} GB in all, init "
        f"{time.perf_counter() - t:.1f} s")
    mixtral = {kv: zoo_mixtral(torch, np, L, lm, mparams, mcfg,
                               att_recorders, seed, kv)
               for kv in ("bfloat16", "int8")}
    del mparams
    torch.cuda.empty_cache()
    pali = zoo_paligemma(torch, np, L, lm, att_recorders, seed)
    gc.collect()
    torch.cuda.empty_cache()
    dense = {}
    for arch in DENSE_ARCHS:
        dense[arch] = zoo_dense(torch, np, L, lm, arch, att_recorders, seed)
    launches = dict.fromkeys(ATT_KEYS, 0)
    for r in (*mixtral.values(), pali, *dense.values()):
        for k, v in r["launches"].items():
            launches[k] += v
    wall = time.perf_counter() - t0
    log(f"[zoo] phase done in {wall:.1f} s ("
        + ", ".join(f"{a} {r['wall_s']:.1f} s" for a, r in dense.items())
        + f"); launches {launches}")
    return {"mixtral": mixtral, "paligemma": pali, "dense": dense,
            "launches": launches, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 11: the MLA kind and the encoder-decoder
# ---------------------------------------------------------------------------

MLA_SLOTS, MLA_MAX, MLA_PROMPT, MLA_STEPS = 4, 8192, 4096, 16
DEEPSEEK_LAYERS = 4  # of 60: the dense layer 0 and 3 MoE layers; 60 layers
                     # in bf16 are 471.5 GB, over the card's 80 GB; widths,
                     # heads, experts and ranks unchanged
WHISPER_B, WHISPER_TEXT, WHISPER_STEPS = 2, 64, 16
PLAIN_ROWS = 1024    # query rows a plain prefill attention call takes at
                     # once: deepseek's f32 scores over 128 heads and 4,096
                     # keys would be 8.6 GB a copy


def plain_rows(torch, L, hole: bool = False):
    """K4's plain version (``L.flash_attention_plain``) over PLAIN_ROWS
    query rows at a time, which gives the same rows (each row's output
    depends on its own scores alone). ``hole``: the rows of the last
    quarter see the keys with one FAULT_TILE-key tile at L/2 left out, the
    planted fault of ``flash_tile_dropped`` (causal prefill only)."""
    def flash(q, k, v, *, causal=True, window=None, prefix_len=0,
              q_offset=0, kv_valid_len=None):
        Lq, Lkv = q.shape[1], k.shape[1]
        lo, r_hole = Lkv // 2, 3 * Lq // 4
        outs = []
        for r0 in range(0, Lq, PLAIN_ROWS):
            kk, vv, off = k, v, q_offset + r0
            if hole:
                check(causal and Lq == Lkv and r_hole % PLAIN_ROWS == 0,
                      "[mla] the planted fault is a causal prefill's")
            if hole and r0 >= r_hole:
                kk, vv = (torch.cat([x[:, :lo], x[:, lo + FAULT_TILE:]], 1)
                          for x in (k, v))
                off -= FAULT_TILE
            outs.append(L.flash_attention_plain(
                q[:, r0:r0 + PLAIN_ROWS], kk, vv, causal=causal,
                window=window, prefix_len=prefix_len, q_offset=off,
                kv_valid_len=kv_valid_len))
        return torch.cat(outs, dim=1)
    return flash


def log_mla_trace(what: str, tr: dict, step_ms) -> None:
    log_zoo_trace(what, tr, tag="mla")
    if tr and step_ms:
        tr["idle_share"] = 1 - tr["busy_ms"] / step_ms
        log(f"[mla] {what}: idle share {tr['idle_share']:.3f} of the "
            f"unprofiled median ({step_ms:.2f} ms)")


def mla_engine(torch, np, L, lm, params, cfg, att_recorders, seed: int
               ) -> dict:
    """An MLA model (``mla_absorb`` off in ``cfg``) at full width through
    ModelEngine(n_slots=4, max_len=8192): the first prompt's prefill logits
    held against the plain layers (rows in blocks, ``plain_rows``), which a
    kv tile dropped from the plain prefill must move past ZOO_RTOL; four
    4,096-token prompts prefilled (K4's Dv mode on every layer), then the
    first decode step's logits held against the plain layers in each form
    (materialised: K3's Dv mode; absorbed: f32 products, no kernel) and the
    two forms against each other; then 16 steps in each form from the same
    state (K3's Dv mode on every layer of the materialised steps, no K3 in
    the absorbed ones). Launch counters zeroed and read around each window,
    every K3/K4 call recorded for the re-checks; profiled prefill and
    decode of each form."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serving.engine import ModelEngine
    n = cfg.n_layers
    name = cfg.name
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, MLA_PROMPT)
               for _ in range(MLA_SLOTS)]
    first = {"tokens": torch.tensor(prompts[0][None], device=DEV)}
    rec: dict = {}
    with torch.inference_mode():
        def prefill1():
            return lm.prefill(params, cfg, first, lm.init_cache(
                cfg, 1, MLA_PROMPT, device=DEV))[0]
        plain = plain_rows(torch, L)
        with routing(L) as kr:
            kl = prefill1()
        with routing(L) as pr, swap_attention(L, flash=plain):
            pl = prefill1()
        rec["prefill"] = zoo_held(torch, L, cfg, f"{name} prefill", prefill1,
                                  kl, kr.idx, pl, pr.idx, flash=plain)
        with routing(L, force=pr.idx), swap_attention(
                L, flash=plain_rows(torch, L, hole=True)):
            fl = prefill1()
        rec["rel_diff_planted_fault"] = f = zoo_rel(torch, cfg, fl, pl)
        check(f > ZOO_RTOL, f"[mla] {name}: a kv tile dropped from the plain "
                            f"prefill moves the logits by {f:.4g} of the "
                            f"largest, within ZOO_RTOL {ZOO_RTOL}")
        log(f"[mla] {name} planted fault (one {FAULT_TILE}-key tile dropped "
            f"from the last quarter of the prefill rows, every layer): "
            f"logits move by {f:.4g} of the largest (limit {ZOO_RTOL})")
        del kl, pl, fl
    torch.cuda.empty_cache()
    eng = ModelEngine(params, cfg, n_slots=MLA_SLOTS, max_len=MLA_MAX,
                      device=DEV)
    check(set(eng.cache) == {"latent", "krope"}, f"[mla] {name}: cache keys")
    torch.cuda.synchronize()
    zero_attention_launches()
    prefill_ms, toks = [], []
    with recorded_ops(L, att_recorders):
        for s, p in enumerate(prompts):
            t0 = time.perf_counter()
            toks.append(eng.prefill_into(s, p))
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
    launches = attention_launches()
    check(launches["flash_attention_dv"] == MLA_SLOTS * n
          and sum(launches.values()) == MLA_SLOTS * n,
          f"[mla] {name} prefill: launches {launches}, expected "
          f"{MLA_SLOTS * n} K4 in the Dv mode and nothing else")
    persistent = fa_ops.flash_attention.launches_persistent
    check(persistent == MLA_SLOTS * n,
          f"[mla] {name} prefill: {persistent} K4 launches on "
          f"flash_bf16_persistent, expected every one of {MLA_SLOTS * n}")
    toks = np.asarray(toks, np.int64)
    start = ({k: v.clone() for k, v in eng.cache.items()}, eng.pos.copy(),
             toks.copy())
    forms = {"materialised": cfg, "absorbed": cfg.replace(mla_absorb=True)}
    first_logits = {}
    with torch.inference_mode():
        pos = torch.tensor(eng.pos.astype(np.int64), device=DEV)
        tok = torch.tensor(toks, device=DEV)[:, None]
        for form, c in forms.items():
            def decode1(c=c):
                return lm.decode_step(params, c, tok, eng.cache, pos,
                                      kv_len=pos + 1, moe_groups=MLA_SLOTS,
                                      kv_max=int(eng.pos.max()) + 1)[0]
            with routing(L) as kr:
                first_logits[form] = kd = decode1()
            with routing(L) as pr, swap_attention(L):
                pd = decode1()
            rec[f"decode_{form}"] = zoo_held(
                torch, L, c, f"{name} {form} decode", decode1, kd, kr.idx, pd,
                pr.idx)
            del pd
        rec["rel_diff_forms"] = rf = zoo_rel(torch, cfg,
                                             first_logits["absorbed"],
                                             first_logits["materialised"])
        check(rf <= ZOO_RTOL, f"[mla] {name}: the absorbed and materialised "
                              f"decode's logits differ by {rf:.4g} of the "
                              f"largest, over {ZOO_RTOL}")
        del first_logits
    steps: dict = {}
    for form, c in forms.items():
        cache, pos0, toks0 = start
        for k, v in cache.items():
            eng.cache[k].copy_(v)
        eng.pos[:] = pos0
        eng.cfg = c
        out, decode_ms = toks0.copy(), []
        torch.cuda.synchronize()
        zero_attention_launches()
        mark = len(att_recorders[1].n_split)
        with recorded_ops(L, att_recorders):
            for _ in range(MLA_STEPS):
                t0 = time.perf_counter()
                out = eng.decode_active(out)
                decode_ms.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        got = attention_launches()
        want = 0 if c.mla_absorb else MLA_STEPS * n
        check(got["decode_attention_dv"] == want
              and sum(got.values()) == want,
              f"[mla] {name} {form} decode: launches {got}, expected {want}"
              f" K3 in the Dv mode and nothing else")
        check(all(0 <= t < cfg.vocab_size for t in out),
              f"[mla] {name} {form}: bad tokens {out}")
        # K3's Dv mode on its fast kernel in every call: a reroute to the
        # generic kernel (last_n_split 0) fails the run
        splits = att_recorders[1].n_split[mark:]
        check(len(splits) == want and all(x > 0 for x in splits),
              f"[mla] {name} {form} decode: K3 splits {sorted(set(splits))}"
              f" over {len(splits)} calls; every call must take the fast "
              f"kernel")
        if want:
            log(f"[mla] {name} {form} decode: all {want} K3 calls took the "
                f"fast kernel, splits {sorted(set(splits))}")
        for k, v in got.items():
            launches[k] += v
        steps[form] = {"decode_ms": decode_ms,
                       "decode_ms_median": statistics.median(decode_ms),
                       "tokens": out.tolist()}
        steps[form]["trace"] = tr = zoo_trace(
            torch, L, lambda: [eng.decode_active(out) for _ in range(2)], 2)
        log_mla_trace(f"{name} {form}, profiled decode (per step of 2)", tr,
                      steps[form]["decode_ms_median"])
    eng.cfg = cfg
    same = float(np.mean(np.asarray(steps["materialised"]["tokens"])
                         == np.asarray(steps["absorbed"]["tokens"])))
    rec.update(launches=launches, prefill_ms=prefill_ms,
               prefill_ms_median=statistics.median(prefill_ms), steps=steps,
               last_tokens_equal_share=same,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    flips = {k: [round(x, 4) for x in rec[k]["routing_flip_share"]]
             for k in ("prefill", "decode_materialised", "decode_absorbed")}
    log(f"[mla] {name}: {MLA_SLOTS} prompts of {MLA_PROMPT} tokens, prefill "
        f"{rec['prefill_ms_median']:.1f} ms per prompt (median; "
        f"{', '.join(f'{t:.1f}' for t in prefill_ms)}), {MLA_STEPS} decode "
        f"steps {steps['materialised']['decode_ms_median']:.2f} ms per step "
        f"materialised, {steps['absorbed']['decode_ms_median']:.2f} ms "
        f"absorbed (medians); kernel vs plain logits "
        f"{rec['prefill']['rel_diff']:.4g} (prefill), "
        f"{rec['decode_materialised']['rel_diff']:.4g} (materialised decode)"
        f", {rec['decode_absorbed']['rel_diff']:.4g} (absorbed decode) of "
        f"the largest (held {rec['prefill']['rel_diff_held']:.4g} / "
        f"{rec['decode_materialised']['rel_diff_held']:.4g} / "
        f"{rec['decode_absorbed']['rel_diff_held']:.4g}, limit {ZOO_RTOL});"
        f" absorbed vs materialised {rf:.4g}; the two forms' tokens after "
        f"{MLA_STEPS} steps equal in {same:.2f} of the slots; routing flips "
        f"per layer {flips}; launches {launches}; peak memory "
        f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")
    rec["prefill_trace"] = tr = zoo_trace(
        torch, L, lambda: eng.prefill_into(0, prompts[0]), 1)
    log_mla_trace(f"{name}, profiled prefill of {MLA_PROMPT} tokens", tr,
                  rec["prefill_ms_median"])
    del eng, start
    torch.cuda.empty_cache()
    return rec


def mla_whisper(torch, np, L, lm, att_recorders, seed: int) -> dict:
    """whisper-base at full size: ``lm.prefill`` of B = 2 with 1,500 seeded
    stub frames (the encoder: K4 non-causal over 1,500 frames) and 64 text
    tokens (K4 causal; the cross-attention: K4 non-causal, 64 queries over
    1,500 keys), then 16 greedy ``decode_step``s (K3 over the self cache
    and over the 1,500 cross positions). The prefill's and the first
    step's logits held against the plain layers; the encoder's attention
    made causal must move them past ZOO_RTOL."""
    from repro_torch.configs.base import get_config
    cfg = get_config("whisper-base")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(gen(torch, seed + 41), cfg, device=DEV)
    torch.cuda.synchronize()
    log(f"[mla] {cfg.name} {cfg.enc_layers}+{cfg.n_layers} layers d="
        f"{cfg.d_model} heads={cfg.n_heads} of {cfg.head_dim} d_ff="
        f"{cfg.d_ff} ({cfg.act}, ungated) enc_len={cfg.enc_len} vocab="
        f"{cfg.vocab_size} bf16, LayerNorm, tied embeddings: "
        f"{lm.n_params(params) / 1e6:.1f}M params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 42)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (WHISPER_B, WHISPER_TEXT)), device=DEV),
        "frames": torch.randn(
            (WHISPER_B, cfg.enc_len, cfg.d_model), generator=gen(
                torch, seed + 43), device=DEV).to(torch.bfloat16)}
    max_len = WHISPER_TEXT + WHISPER_STEPS + 2       # 2 more steps traced

    def new_cache():
        return lm.init_cache(cfg, WHISPER_B, max_len, device=DEV)
    rec: dict = {}
    n, n_enc = cfg.n_layers, cfg.enc_layers
    with torch.inference_mode():
        torch.cuda.synchronize()
        zero_attention_launches()
        with recorded_ops(L, att_recorders):
            t0 = time.perf_counter()
            kl, cache = lm.prefill(params, cfg, batch, new_cache())
            torch.cuda.synchronize()
            rec["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            start = {k: v.clone() for k, v in cache.items()}
            nxt0 = nxt = torch.argmax(kl, dim=-1)[:, None]
            decode_ms = []
            for step in range(WHISPER_STEPS):
                t0 = time.perf_counter()
                d, cache = lm.decode_step(params, cfg, nxt, cache,
                                          WHISPER_TEXT + step)
                nxt = torch.argmax(d, dim=-1)[:, None]
                torch.cuda.synchronize()
                decode_ms.append(1e3 * (time.perf_counter() - t0))
                if step == 0:
                    kd = d
        launches = attention_launches()
        want_k4, want_k3 = n_enc + 2 * n, WHISPER_STEPS * 2 * n
        check(launches["flash_attention"] == want_k4
              and launches["decode_attention"] == want_k3
              and sum(launches.values()) == want_k4 + want_k3,
              f"[mla] whisper: launches {launches}, expected {want_k4} K4 "
              f"and {want_k3} K3")
        with swap_attention(L):
            pl, _ = lm.prefill(params, cfg, batch, new_cache())
            pd, _ = lm.decode_step(params, cfg, nxt0, start, WHISPER_TEXT)

        def causal_encoder(q, k, v, *, causal=True, **kw):
            if not causal and q.shape[1] == k.shape[1] == cfg.enc_len:
                causal = True
            return L.flash_attention_plain(q, k, v, causal=causal, **kw)
        with swap_attention(L, flash=causal_encoder):
            fl, _ = lm.prefill(params, cfg, batch, new_cache())
        rec["rel_diff_prefill"] = rp = zoo_rel(torch, cfg, kl, pl)
        rec["rel_diff_decode"] = rd = zoo_rel(torch, cfg, kd, pd)
        rec["rel_diff_planted_fault"] = f = zoo_rel(torch, cfg, fl, pl)
        check(rp <= ZOO_RTOL and rd <= ZOO_RTOL,
              f"[mla] whisper: kernel vs plain logits differ by {rp:.4g} "
              f"(prefill) / {rd:.4g} (decode) of the largest, over "
              f"{ZOO_RTOL}")
        check(f > ZOO_RTOL, f"[mla] whisper: the encoder made causal moves "
                            f"the logits by {f:.4g} of the largest, within "
                            f"ZOO_RTOL {ZOO_RTOL}")
        del pl, pd, fl, start
        rec.update(launches=launches, decode_ms=decode_ms,
                   decode_ms_median=statistics.median(decode_ms),
                   tokens=nxt[:, 0].tolist(),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[mla] whisper: B={WHISPER_B}, {cfg.enc_len} frames + "
            f"{WHISPER_TEXT} text tokens, prefill {rec['prefill_ms']:.1f} ms,"
            f" {WHISPER_STEPS} decode steps {rec['decode_ms_median']:.2f} ms "
            f"per step (median); kernel vs plain logits {rp:.4g} (prefill) "
            f"and {rd:.4g} (decode) of the largest (limit {ZOO_RTOL}); "
            f"planted fault (the encoder made causal) {f:.4g}; launches "
            f"{launches}; peak memory "
            f"{rec['max_memory_allocated'] / 2**30:.2f} GiB")
        pos = [WHISPER_TEXT + WHISPER_STEPS]

        def two_steps():
            nonlocal cache, nxt
            for _ in range(2):
                d, cache = lm.decode_step(params, cfg, nxt, cache, pos[0])
                nxt = torch.argmax(d, dim=-1)[:, None]
                pos[0] += 1
        rec["decode_trace"] = tr = zoo_trace(torch, L, two_steps, 2)
        log_mla_trace("whisper, profiled decode (per step of 2)", tr,
                      rec["decode_ms_median"])
        rec["prefill_trace"] = tr = zoo_trace(
            torch, L, lambda: lm.prefill(params, cfg, batch, new_cache()), 1)
        log_mla_trace("whisper, profiled prefill", tr, rec["prefill_ms"])
    del params, cache
    torch.cuda.empty_cache()
    return rec


def phase_mla_encdec(torch, np, att_recorders, seed: int) -> dict:
    """Phase 11: minicpm3-4b at full size and deepseek-v2-236b at full
    width cut to DEEPSEEK_LAYERS layers (its dense layer 0 and MoE layers)
    through ModelEngine (``mla_engine``), then whisper-base at full size
    through lm.prefill / decode_step (``mla_whisper``). Every K3/K4 call is
    noted for the re-checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L, lm
    t0 = time.perf_counter()
    out: dict = {}
    for i, (arch, layers) in enumerate((("minicpm3-4b", None),
                                        ("deepseek-v2-236b",
                                         DEEPSEEK_LAYERS))):
        full = get_config(arch)
        cfg = full if layers is None else full.replace(n_layers=layers)
        t = time.perf_counter()
        params = lm.init_params(gen(torch, seed + 30 + i), cfg, device=DEV)
        torch.cuda.synchronize()
        nbytes = lm.n_params(params) * 2
        cut = ""
        if layers is not None:
            moe_layer = lm.n_params(params["blocks"][0]) * 2
            total = nbytes + (full.n_layers - layers) * moe_layer
            cut = (f"; depth cut to {layers} of {full.n_layers} layers (the "
                   f"dense layer 0 and {layers - 1} MoE layers; "
                   f"{full.n_layers} layers in bf16: {total / 1e9:.1f} GB, "
                   f"over the card's 80 GB)")
        log(f"[mla] {arch} d={cfg.d_model} heads={cfg.n_heads} q_lora="
            f"{cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} Dq="
            f"{cfg.qk_nope_dim}+{cfg.qk_rope_dim} Dv={cfg.v_head_dim} "
            + (f"{cfg.n_experts} experts of {cfg.d_ff_expert} top-"
               f"{cfg.top_k} + {cfg.n_shared_experts} shared, dense d_ff "
               f"{cfg.d_ff} " if cfg.is_moe else f"d_ff={cfg.d_ff} ")
            + f"vocab={cfg.vocab_size} layers={cfg.n_layers} bf16: "
            f"{nbytes / 1e9:.1f} GB, init {time.perf_counter() - t:.1f} s"
            + cut)
        out[arch] = mla_engine(torch, np, L, lm, params, cfg, att_recorders,
                               seed + 35 + i)
        del params
        torch.cuda.empty_cache()
    out["whisper-base"] = mla_whisper(torch, np, L, lm, att_recorders, seed)
    launches = dict.fromkeys(ATT_KEYS, 0)
    for r in out.values():
        for k, v in r["launches"].items():
            launches[k] += v
    wall = time.perf_counter() - t0
    log(f"[mla] phase done in {wall:.1f} s; launches {launches}")
    return {**out, "launches": launches, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 12: the SSM kind and the hybrid
# ---------------------------------------------------------------------------

RWKV_PROMPTS = (2048, 1999, 1537, 1024)
RWKV_SLOTS, RWKV_MAX, RWKV_STEPS = 4, 4096, 16
SSM_PLAIN_STEPS = 4     # the held runs: one prompt (rwkv6's shortest, the
                        # plain recurrence being a Python loop of L steps a
                        # layer) and 4 decode steps
ZAMBA_SLOTS, ZAMBA_MAX, ZAMBA_PROMPT, ZAMBA_STEPS = 4, 8192, 4096, 16
SSM_F32_RTOL = 1e-3  # the held runs' logits, in f32 (the bf16 weights
                     # widened): the largest |kernel - plain| over the
                     # largest |plain| logit
SSM_BF16_RTOL = {"rwkv6": 0.1, "zamba2": ZOO_RTOL}
                     # the same in bf16, each bf16 kernel call also held
                     # against its plain version on its own inputs. In
                     # rwkv6's 32 layers one f32 ulp of noise in each WKV6
                     # output moves the logits by 0.0554-0.0667 of the
                     # largest (``ssm_held``'s floor run on an H100), past
                     # ZOO_RTOL: its limit sits above that floor and below
                     # its planted fault
BF16_FLOOR_NOISE = {"wkv6": 2.0 ** -23, "attention": 2.0 ** -9}
                    # the floor run's relative noise on the plain outputs:
                    # an f32 ulp on WKV6's f32 y, a quarter of a bf16 ulp on
                    # the attention's bf16 output before it is rounded
WKV6_RTOL = 1e-5    # of the largest |y| or |state|: the kernel's f32 FMAs
                    # against the plain loop's products and sums, a few
                    # ulps that the decay keeps from growing
WKV6_TIMED = dict(B=1, L=2048, H=64, K=64)      # rwkv6-7b's prefill
# zamba2-7b's shared attention block: 32 heads of 112 (MHA); its prefill of
# a 4,096-token prompt and its engine's decode (4 slots, Lc 8,192, kv_len
# 4,096)
ZAMBA_PREFILL_SHAPE = dict(B=1, Lq=4096, Lkv=4096, H=32, Hkv=32, Dh=112)
ZAMBA_DECODE_SHAPE = dict(B=4, H=32, Hkv=32, Dh=112)
ZAMBA_DECODE_TIMED = (8192, 4096)


class held_calls:
    """Within the block, every WKV6, K4 and K3 call of the model runs the
    kernel and, on the same inputs, its plain version (``flash_plain`` for
    prefill attention; K3's ``ref.decode_attention_ref``, whose P stays f32
    as the kernel's does); the kernel's output goes on. WKV6 is held at
    WKV6_RTOL of the largest |y| and |state|, K3/K4 by ``agree`` (the bf16
    limits). ``n`` counts the calls held, ``wkv6_err`` WKV6's largest
    |kernel - plain|."""

    def __init__(self, torch, L, S, agree, flash_plain):
        self.torch, self.L, self.S = torch, L, S
        self.agree, self.flash_plain = agree, flash_plain
        self.n, self.wkv6_err = 0, 0.0

    def __enter__(self):
        from repro_torch.kernels.wkv6.ref import wkv6_ref
        torch, L, S = self.torch, self.L, self.S
        self.saved = (L.flash_attention, L.decode_attention, S.wkv6_ops)
        flash, decode, wkv_ops = self.saved

        def held_flash(q, k, v, **kw):
            out = flash(q, k, v, **kw)
            self.agree.hold(torch, "flash_attention", out,
                            self.flash_plain(q, k, v, **kw),
                            f"[ssm] K4 call {tuple(q.shape)} {kw}")
            self.n += 1
            return out

        def held_decode(q, k_cache, v_cache, *, kv_len, **kw):
            from repro_torch.kernels.decode_attention import ref
            out = decode(q, k_cache, v_cache, kv_len=kv_len, **kw)
            plain = ref.decode_attention_ref(q[:, 0], k_cache, v_cache,
                                             kv_len)     # K3's own form
            self.agree.hold(torch, "decode_attention", out,
                            plain[:, None], f"[ssm] K3 call "
                            f"{tuple(q.shape)} Lc {k_cache.shape[1]}")
            self.n += 1
            return out

        def held_wkv(r, k, v, w, u, state):
            y, s = wkv_ops.wkv6(r, k, v, w, u, state)
            plain = wkv6_ref(r, k, v, w, u, state)
            for out, ref, what in zip((y, s), plain, ("y", "state")):
                e = float((out - ref).abs().max())
                lim = WKV6_RTOL * float(ref.abs().max())
                check(e <= lim, f"[ssm] WKV6 call {tuple(r.shape)}: {what} "
                                f"max abs err {e:.4g} over {lim:.4g}")
                self.wkv6_err = max(self.wkv6_err, e)
            self.n += 1
            return y, s
        L.flash_attention, L.decode_attention = held_flash, held_decode
        S.wkv6_ops = SimpleNamespace(wkv6=held_wkv)
        return self

    def __exit__(self, *exc):
        (self.L.flash_attention, self.L.decode_attention,
         self.S.wkv6_ops) = self.saved


def noisy(torch, fn, rel: float):
    """``fn`` with its (first) output times 1 + rel N(0, 1), seeded by the
    call's order: a run at the floor that rounding noise of that size
    sets."""
    calls = [0]

    def out_fn(*a, **kw):
        out = fn(*a, **kw)
        y = out[0] if isinstance(out, tuple) else out
        calls[0] += 1
        eps = torch.randn(y.shape, generator=gen(torch, calls[0]),
                          device=y.device)
        z = (y.float() * (1 + rel * eps)).to(y.dtype)
        return (z, *out[1:]) if isinstance(out, tuple) else z
    return out_fn


def f32_copy(tree):
    """The params tree with every tensor widened to f32 (a new copy)."""
    if isinstance(tree, dict):
        return {k: f32_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_copy(v) for v in tree]
    return tree.float()


def ssm_held(torch, L, S, lm, cfg, params, prompt, step_toks, swaps: dict,
             agree, tag: str) -> dict:
    """The held runs: ``prompt`` (1, Lp) through lm.prefill and the decode
    steps of ``step_toks``, every logit of the kernel run against the plain
    run (``swaps["plain"]``, ``swap_attention``'s arguments). (1) In f32,
    the bf16 weights widened: within SSM_F32_RTOL of the largest, and the
    planted fault (``swaps["fault"]``) past it. (2) In bf16, every kernel
    call held against its plain version on its own inputs
    (``held_calls``): within SSM_BF16_RTOL[tag] of the largest, and the
    planted fault past it; the floor run (``swaps["floor"]``: the plain
    outputs with noise of rounding size) against the plain run is logged
    beside them."""
    def run(p, c, swap=None):
        """The kernels, or ``swap_attention(**swap)``'s functions."""
        with torch.inference_mode(), (
                nullcontext() if swap is None
                else swap_attention(L, S=S, **swap)):
            cache = lm.init_cache(c, 1, prompt.shape[1] + len(step_toks),
                                  device=DEV)
            out, cache = lm.prefill(p, c, {"tokens": prompt}, cache)
            outs = [out]
            for i, tok in enumerate(step_toks):
                d, cache = lm.decode_step(p, c, tok, cache,
                                          prompt.shape[1] + i)
                outs.append(d)
            return outs

    def rels(c, a, b):
        return [zoo_rel(torch, c, x, y) for x, y in zip(a, b)]
    rec: dict = {}
    t0 = time.perf_counter()
    c32, p32 = cfg.replace(dtype="float32"), f32_copy(params)
    k32, pl32 = run(p32, c32), run(p32, c32, swaps["plain"])
    fl32 = run(p32, c32, swaps["fault"])
    del p32
    torch.cuda.empty_cache()
    rec["f32_rel_diff"] = r32 = rels(c32, k32, pl32)
    rec["f32_rel_diff_planted_fault"] = f32 = rels(c32, fl32, pl32)
    del k32, pl32, fl32
    check(max(r32) <= SSM_F32_RTOL,
          f"[ssm] {tag} f32: kernel vs plain logits differ by "
          f"{[round(x, 7) for x in r32]} of the largest (prefill, then "
          f"{len(step_toks)} steps), over {SSM_F32_RTOL}")
    check(max(f32) > SSM_F32_RTOL,
          f"[ssm] {tag} f32: the planted fault moves the logits by "
          f"{[round(x, 7) for x in f32]} of the largest, within "
          f"{SSM_F32_RTOL}")
    t1 = time.perf_counter()
    with held_calls(torch, L, S, agree, swaps["plain"].get(
            "flash", L.flash_attention_plain)) as held:
        kb = run(params, cfg)
    pb = run(params, cfg, swaps["plain"])
    nb, fb = (run(params, cfg, swaps[x]) for x in ("floor", "fault"))
    rec["bf16_rel_diff"] = rb = rels(cfg, kb, pb)
    rec["bf16_floor_rel_diff"] = nf = rels(cfg, nb, pb)
    rec["bf16_rel_diff_planted_fault"] = fbr = rels(cfg, fb, pb)
    rec.update(bf16_calls_held=held.n, wkv6_err=held.wkv6_err,
               held_s=time.perf_counter() - t0)
    lim = SSM_BF16_RTOL[tag]
    log(f"[ssm] {tag} held runs ({prompt.shape[1]}-token prompt, "
        f"{len(step_toks)} decode steps; prefill, then each step): f32 "
        f"kernel vs plain logits {', '.join(f'{x:.3g}' for x in r32)} of "
        f"the largest (limit {SSM_F32_RTOL}), planted fault "
        f"{', '.join(f'{x:.4g}' for x in f32)}; bf16: {held.n} kernel calls "
        f"each held against its plain version on its own inputs, kernel vs "
        f"plain logits {', '.join(f'{x:.4g}' for x in rb)} (limit {lim}), "
        f"planted fault {', '.join(f'{x:.4g}' for x in fbr)}, the floor run "
        f"(plain outputs with noise of rounding size) against plain "
        f"{', '.join(f'{x:.4g}' for x in nf)}; f32 runs {t1 - t0:.1f} s, "
        f"bf16 runs {time.perf_counter() - t1:.1f} s")
    check(max(rb) <= lim,
          f"[ssm] {tag} bf16: kernel vs plain logits differ by "
          f"{[round(x, 5) for x in rb]} of the largest, over {lim}")
    check(max(fbr) > lim,
          f"[ssm] {tag} bf16: the planted fault moves the logits by "
          f"{[round(x, 5) for x in fbr]} of the largest, within {lim}")
    return rec


def wkv6_update_first(torch):
    """The planted fault: the plain recurrence with each step's update
    applied before its y (y_t read from S_t, not S_{t-1}), in
    ``kernels.wkv6.ops.wkv6``'s signature."""
    def fault(r, k, v, w, u, state):
        S = state.float()
        uf = u.float()[None, :, :, None]
        ys = []
        for t in range(r.shape[1]):
            rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
            kv = kt[..., :, None] * vt[..., None, :]
            S = wt[..., None] * S + kv
            ys.append(torch.einsum("bhk,bhkv->bhv", rt, S + uf * kv))
        return torch.stack(ys, dim=1), S
    return fault


def wkv6_inputs(torch, B, L, H, K, dtype, carried: bool, seed: int):
    """r, k, v (B, L, H, K) in ``dtype``; w from the reference's decay
    formula over its clipped exponent's middle band [-3, 1]; u (H, K) in
    ``dtype``; a random (carried) or zero state (B, H, K, K) f32."""
    g = gen(torch, seed)
    r, k, v = (torch.randn((B, L, H, K), generator=g, device=DEV).to(dtype)
               for _ in range(3))
    w_raw = -3.0 + 4.0 * torch.rand((B, L, H, K), generator=g, device=DEV)
    w = torch.exp(-torch.exp(w_raw))
    u = torch.randn((H, K), generator=g, device=DEV).to(dtype)
    s = torch.randn((B, H, K, K), generator=g, device=DEV)
    return r, k, v, w, u, s if carried else torch.zeros_like(s)


def compare_wkv6(torch, shape, dt: str, carried: bool, seed: int) -> float:
    """The WKV6 kernel against its plain loop at a call's own arguments:
    y and the final state within WKV6_RTOL of their largest |value|.
    Returns the largest |kernel - plain|."""
    from repro_torch.kernels.wkv6 import ops, ref
    B, L, H, K = shape
    args = wkv6_inputs(torch, B, L, H, K, getattr(torch, dt), carried, seed)
    y, S = ops.wkv6(*args)
    py, pS = ref.wkv6_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for out, plain, what in ((y, py, "y"), (S, pS, "state")):
        check(bool(torch.isfinite(out).all()),
              f"[ssm] wkv6 {shape} {dt}: non-finite {what}")
        e = float((out - plain).abs().max())
        lim = WKV6_RTOL * float(plain.abs().max())
        check(e <= lim, f"[ssm] wkv6 {shape} {dt} carried={carried}: {what} "
                        f"max abs err {e:.4g} over {lim:.4g} ({WKV6_RTOL} "
                        f"of the largest)")
        err = max(err, e)
    return err


def ssm_trace(torch, fn, n: int) -> dict:
    """``fn`` (``n`` repeats of the work) under torch.profiler: per repeat,
    the device's busy ms, WKV6's (``wkv6_fwd``), K4's (``flash_bf16``) and
    K3's (``da::decode``) ms and shares, the largest kernels. Empty where
    the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    tr = device_summary(prof, n)
    if not tr:
        return {}
    by_name = tr.pop("by_name_ms")
    out = {"busy_ms": tr["busy_ms"], "device_events": tr["device_events"],
           "top_kernels_ms": tr["top_kernels_ms"]}
    for key, tag in (("wkv6", "wkv6_fwd"), ("k4", "flash_bf16"),
                     ("k3", "da::decode")):
        out[f"{key}_ms"] = ms = sum(t for k, t in by_name.items()
                                    if tag in k)
        out[f"{key}_share"] = ms / out["busy_ms"]
    return out


def log_ssm_trace(what: str, tr: dict, step_ms=None) -> None:
    if not tr:
        log(f"[ssm] {what}: the profiler recorded no device activity; the "
            f"split is not measured")
        return
    if step_ms:
        tr["idle_share"] = 1 - tr["busy_ms"] / step_ms
    log(f"[ssm] {what}: device busy {tr['busy_ms']:.3f} ms "
        f"({tr['device_events']} device events)"
        + "".join(f", {name} {tr[f'{key}_ms']:.3f} ms "
                  f"({tr[f'{key}_share']:.3f})"
                  for key, name in (("wkv6", "WKV6"), ("k4", "K4"),
                                    ("k3", "K3")) if tr[f"{key}_ms"])
        + ("" if not step_ms else
           f"; idle share {tr['idle_share']:.3f} of the unprofiled median "
           f"({step_ms:.2f} ms)")
        + "; most device time: "
        + "; ".join(f"{n} {t:.3f} ms" for n, t in tr["top_kernels_ms"]))


def ssm_init(torch, lm, arch: str, seed: int):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    t = time.perf_counter()
    params = lm.init_params(gen(torch, seed), cfg, device=DEV)
    torch.cuda.synchronize()
    f32 = sum(x.numel() * 4 for bp in params["blocks"] for x in bp.values()
              if isinstance(x, torch.Tensor) and x.dtype == torch.float32)
    log(f"[ssm] {arch} layers={cfg.n_layers} d={cfg.d_model} "
        f"{cfg.ssm_kind} heads={cfg.ssm_heads}x{cfg.ssm_head_dim}"
        + (f" state={cfg.ssm_state} d_inner={cfg.d_inner} conv="
           f"{cfg.conv_kernel} chunk={cfg.chunk_size}, shared block "
           f"{cfg.n_heads}x{cfg.head_dim} every {cfg.attn_every} layers, "
           f"LoRA rank {cfg.shared_lora_rank}" if cfg.attn_every else "")
        + f" d_ff={cfg.d_ff} vocab={cfg.vocab_size} bf16: "
        f"{lm.n_params(params) / 1e9:.2f}B params "
        f"({(lm.n_params(params) * 2 + f32 // 2) / 1e9:.1f} GB; "
        f"{f32 / 1e6:.1f} MB of it f32), init "
        f"{time.perf_counter() - t:.1f} s")
    return cfg, params


def ssm_prefill_all(torch, np, eng, prompts) -> tuple[list, object]:
    """Prefill every prompt into its slot: host ms of each, synchronised,
    and the first tokens."""
    prefill_ms, toks = [], []
    for s, p in enumerate(prompts):
        t0 = time.perf_counter()
        toks.append(eng.prefill_into(s, p))
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    return prefill_ms, np.asarray(toks, np.int64)


def ssm_decode_steps(torch, eng, toks, steps: int, tag: str):
    """``steps`` batched decode steps: host ms of each, synchronised, and
    the last tokens."""
    decode_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        toks = eng.decode_active(toks)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
    check(all(0 <= t < eng.cfg.vocab_size for t in toks),
          f"[ssm] {tag}: bad tokens {toks}")
    return decode_ms, toks


def ssm_rwkv6(torch, np, L, lm, S, recorders, agree, seed: int) -> dict:
    """rwkv6-7b at full size. (1) ``ssm_held`` over its shortest prompt and
    SSM_PLAIN_STEPS decode steps: the WKV6 kernel against the plain step
    loop, the planted fault each step's update before its y;
    (2) ModelEngine(n_slots=4): four prompts of RWKV_PROMPTS tokens, then
    RWKV_STEPS decode steps, every WKV6 call noted by the third
    OpsRecorder of ``recorders``; (3) a profiled prefill and two decode
    steps."""
    from repro_torch.serving.engine import ModelEngine
    cfg, params = ssm_init(torch, lm, "rwkv6-7b", seed + 40)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 41)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in RWKV_PROMPTS]
    short = torch.tensor(min(prompts, key=len), device=DEV)[None]
    step_toks = torch.tensor(rng.integers(0, cfg.vocab_size,
                                          (SSM_PLAIN_STEPS, 1, 1)),
                             device=DEV)
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    rec = ssm_held(torch, L, S, lm, cfg, params, short, step_toks, {
        "plain": {}, "fault": {"wkv": wkv6_update_first(torch)},
        "floor": {"wkv": noisy(torch, wkv6_ref, BF16_FLOOR_NOISE["wkv6"])}},
        agree, "rwkv6")
    eng = ModelEngine(params, cfg, n_slots=RWKV_SLOTS, max_len=RWKV_MAX,
                      device=DEV)
    torch.cuda.synchronize()
    wkv6_ops.wkv6.launches = 0
    with recorded_ops(L, recorders, S):
        prefill_ms, toks = ssm_prefill_all(torch, np, eng, prompts)
        decode_ms, toks = ssm_decode_steps(torch, eng, toks, RWKV_STEPS,
                                           "rwkv6")
    rec["launches"] = n = wkv6_ops.wkv6.launches
    run = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "decode_ms_median": statistics.median(decode_ms)}
    rec.update(run)
    want = (len(prompts) + RWKV_STEPS) * cfg.n_layers
    check(n == want, f"[ssm] rwkv6: {n} WKV6 launches, expected {want}")
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[ssm] rwkv6 engine: prompts {list(RWKV_PROMPTS)}, prefill "
        f"{', '.join(f'{t:.1f}' for t in run['prefill_ms'])} ms, "
        f"{RWKV_STEPS} decode steps {run['decode_ms_median']:.2f} ms per "
        f"step (median); WKV6 launches {n}; peak memory "
        f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")

    def two_steps():
        nonlocal toks
        for _ in range(2):
            toks = eng.decode_active(toks)
    rec["decode_trace"] = tr = ssm_trace(torch, two_steps, 2)
    log_ssm_trace("rwkv6, profiled decode (per step of 2)", tr,
                  run["decode_ms_median"])
    rec["prefill_trace"] = tr = ssm_trace(
        torch, lambda: eng.prefill_into(0, prompts[0]), 1)
    log_ssm_trace(f"rwkv6, profiled prefill of {RWKV_PROMPTS[0]} tokens", tr,
                  run["prefill_ms"][0])
    del eng, params
    torch.cuda.empty_cache()
    return rec


def ssm_zamba2(torch, np, L, lm, S, recorders, agree, seed: int) -> dict:
    """zamba2-7b at full size. (1) ``ssm_held`` over its first prompt and
    SSM_PLAIN_STEPS decode steps: K4 and K3 at Dh 112 against the plain
    attention (prefill over PLAIN_ROWS query rows at a time), the planted
    fault each head's last 16 of 112 output columns dropped in prefill and
    decode; (2)
    ModelEngine(n_slots=4, max_len=8192): four 4,096-token prompts (K4 at
    Dh 112 in 13 invocations each), then 16 decode steps (K3 at Dh 112),
    every K3/K4 call noted by the first two OpsRecorders of
    ``recorders``; (3) a profiled prefill and two decode steps."""
    from repro_torch.serving.engine import ModelEngine
    cfg, params = ssm_init(torch, lm, "zamba2-7b", seed + 50)
    n_inv = cfg.n_layers // cfg.attn_every
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 51)
    prompts = [rng.integers(0, cfg.vocab_size, ZAMBA_PROMPT)
               for _ in range(ZAMBA_SLOTS)]
    step_toks = torch.tensor(rng.integers(0, cfg.vocab_size,
                                          (SSM_PLAIN_STEPS, 1, 1)),
                             device=DEV)
    plain_flash = plain_rows(torch, L)

    def columns_dropped(fn):
        def out_fn(*a, **kw):
            out = fn(*a, **kw)
            out[..., -16:] = 0
            return out
        return out_fn
    floor = BF16_FLOOR_NOISE["attention"]
    rec = ssm_held(
        torch, L, S, lm, cfg, params,
        torch.tensor(prompts[0], device=DEV)[None], step_toks, {
            "plain": {"flash": plain_flash},
            "fault": {"flash": columns_dropped(plain_flash),
                      "decode": columns_dropped(L.decode_attention_plain)},
            "floor": {"flash": noisy(torch, plain_flash, floor),
                      "decode": noisy(torch, L.decode_attention_plain,
                                      floor)}},
        agree, "zamba2")
    torch.cuda.empty_cache()
    eng = ModelEngine(params, cfg, n_slots=ZAMBA_SLOTS, max_len=ZAMBA_MAX,
                      device=DEV)
    check(tuple(eng.cache["ak"].shape) == (n_inv, ZAMBA_SLOTS, ZAMBA_MAX,
                                           cfg.n_heads, cfg.head_dim),
          f"[ssm] zamba2 ak cache {tuple(eng.cache['ak'].shape)}")
    torch.cuda.synchronize()
    zero_attention_launches()
    with recorded_ops(L, recorders):
        prefill_ms, toks = ssm_prefill_all(torch, np, eng, prompts)
    launches = attention_launches()
    # every bf16 K4 call of zamba2's prefill (head dim 112) on the
    # persistent kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    persistent = fa_ops.flash_attention.launches_persistent
    check(persistent == launches["flash_attention"] > 0,
          f"[ssm] zamba2 prefill: {persistent} K4 launches on "
          f"flash_bf16_persistent of {launches['flash_attention']}")
    torch.cuda.synchronize()
    zero_attention_launches()
    mark = len(recorders[1].n_split)
    with recorded_ops(L, recorders):
        decode_ms, toks = ssm_decode_steps(torch, eng, toks, ZAMBA_STEPS,
                                           "zamba2")
    for k, v in attention_launches().items():
        launches[k] += v
    # K3 at Dh 112 on its fast kernel in every bf16 call: a reroute to the
    # generic kernel (last_n_split 0) fails the run
    splits = recorders[1].n_split[mark:]
    check(len(splits) == ZAMBA_STEPS * n_inv and all(x > 0 for x in splits),
          f"[ssm] zamba2 decode: K3 splits {sorted(set(splits))} over "
          f"{len(splits)} calls; every call must take the fast kernel")
    log(f"[ssm] zamba2 decode: all {len(splits)} K3 calls took the fast "
        f"kernel, splits {sorted(set(splits))}")
    run = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "decode_ms_median": statistics.median(decode_ms)}
    rec.update(run, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    want_k4, want_k3 = ZAMBA_SLOTS * n_inv, ZAMBA_STEPS * n_inv
    check(launches["flash_attention"] == want_k4
          and launches["decode_attention"] == want_k3,
          f"[ssm] zamba2: launches {launches}, expected {want_k4} K4 and "
          f"{want_k3} K3")
    log(f"[ssm] zamba2 engine: {ZAMBA_SLOTS} prompts of {ZAMBA_PROMPT} "
        f"tokens, prefill "
        f"{', '.join(f'{t:.1f}' for t in run['prefill_ms'])} ms, "
        f"{ZAMBA_STEPS} decode steps {run['decode_ms_median']:.2f} ms per "
        f"step (median); launches {launches}; peak memory "
        f"{rec['max_memory_allocated'] / 2**30:.1f} GiB")

    def two_steps():
        nonlocal toks
        for _ in range(2):
            toks = eng.decode_active(toks)
    rec["decode_trace"] = tr = ssm_trace(torch, two_steps, 2)
    log_ssm_trace("zamba2, profiled decode (per step of 2)", tr,
                  run["decode_ms_median"])
    rec["prefill_trace"] = tr = ssm_trace(
        torch, lambda: eng.prefill_into(0, prompts[0]), 1)
    log_ssm_trace(f"zamba2, profiled prefill of {ZAMBA_PROMPT} tokens", tr,
                  run["prefill_ms"][0])
    del eng, params
    torch.cuda.empty_cache()
    return rec


def wkv6_timing(torch, seed: int) -> dict:
    """The WKV6 kernel at rwkv6-7b's prefill (WKV6_TIMED, bf16 r/k/v, a
    zero state): kernel (CUDA events and torch.profiler), its plain step
    loop, and the bound: the fp32 flops the function needs a (token,
    head), 5 K V + 3 K + 2 V (y_v = sum_k r_k S_kv + v_v sum_k r_k u_k
    k_k: one FMA an entry and O(K) for the bonus; the update w_k S_kv +
    k_k v_v: a product and an FMA an entry), against r, k, v (bf16), w and
    y (f32) and the state in and out (f32) moved once. No single PyTorch
    call computes this function: library_ms is None."""
    from repro_torch.kernels.wkv6 import ops, ref
    B, L, H, K = (WKV6_TIMED[x] for x in "BLHK")
    args = wkv6_inputs(torch, B, L, H, K, torch.bfloat16, False, seed + 36)
    flops = B * L * H * (5.0 * K * K + 3 * K + 2 * K)
    nbytes = (3 * 2 + 4 + 4) * B * L * H * K + 2 * H * K \
        + 2 * 4 * B * H * K * K
    b_ms, b_by = att_bound(nbytes, flops, H100_FP32_FLOPS)
    call = lambda: ops.wkv6(*args)
    rec = {"shape": WKV6_TIMED, "dtype": "bfloat16",
           "ms": cuda_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: ref.wkv6_ref(*args), iters=3,
                               warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    own, _ = device_kernel_ms(torch, call, iters=10)
    kern = {n: t for n, t in own.items() if "wkv6_fwd" in n}
    check(not own or len(kern) == 1,
          f"[timing] wkv6: one call launches {list(own)}")
    rec["device_ms"] = sum(kern.values()) if kern else None
    rec["device_kernels"] = {n.split("(")[0][:60]: t for n, t in own.items()}
    log(f"[timing] wkv6 {WKV6_TIMED} bf16: kernel {rec['ms']:.4f} ms (CUDA "
        f"events), "
        + ("device not measured" if rec["device_ms"] is None else
           f"{rec['device_ms']:.4f} ms on the device "
           f"({b_ms / rec['device_ms']:.3f} of the bound)")
        + f", plain {rec['plain_ms']:.2f} ms, library none, bound "
        f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); device kernels {rec['device_kernels']}")
    return rec


def dh112_timing(torch, seed: int) -> dict:
    """K4 and K3 at zamba2's head dim 112 (ZAMBA_PREFILL_SHAPE causal;
    ZAMBA_DECODE_SHAPE at kv_len 4,096 of 8,192, K3's fast kernel, which
    the timed call must take):
    kernel, plain version, bound and scaled_dot_product_attention (a
    yardstick; the port never calls it), as ``phase_attention_timing``
    times qwen3's."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as da, ref as dr
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    out = {}
    sh = ZAMBA_PREFILL_SHAPE
    B, L, H, Dh = (sh[x] for x in ("B", "Lq", "H", "Dh"))
    q, k, v = flash_inputs(torch, **sh, dtype=torch.bfloat16, seed=seed + 37)
    pairs = L * (L + 1) // 2
    b_ms, b_by = att_bound(2 * 4 * B * L * H * Dh,
                           4.0 * B * H * Dh * pairs, H100_BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    call = lambda: fa.flash_attention(q, k, v, causal=True)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    rec = {"shape": sh, "dtype": "bfloat16", "causal": True,
           "ms": cuda_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: fr.attention_ref(
               q, k, v, causal=True, p_dtype=v.dtype), iters=5, warmup=1),
           "library_ms": cuda_ms(torch, sdpa), "bound_ms": b_ms,
           "bound_by": b_by}
    rec.update(flash_device_ms(torch, call, sdpa,
                               fa.fwd_route(torch.bfloat16, Dh, Dh),
                               "Dh 112 prefill"))
    out["flash_attention/zamba2_prefill"] = rec
    log(f"[timing] flash_attention Dh 112 {sh} bf16: kernel {rec['ms']:.4f}"
        f" ms, plain {rec['plain_ms']:.4f} ms, library "
        f"{rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); device "
        + ("not measured" if rec["device_ms"] is None else
           f"{rec['device_ms']:.4f} ms ({b_ms / rec['device_ms']:.3f} of "
           f"the bound) in {list(rec['device_kernels'])}, library "
           f"{rec['library_device_ms']} ms"))
    del q, k, v, qt, kt, vt
    Lc, n_kv = ZAMBA_DECODE_TIMED
    sh = ZAMBA_DECODE_SHAPE
    B, H, Dh = (sh[x] for x in ("B", "H", "Dh"))
    q, k, v, _ = decode_inputs(torch, **sh, Lc=Lc, qdtype=torch.bfloat16,
                               int8=False, seed=seed + 38)
    kv_len = torch.full((B,), n_kv, device=DEV)
    b_ms, b_by = att_bound(2 * 2 * B * H * Dh + 2 * 2 * B * n_kv * H * Dh
                           + B * 8, 4.0 * B * H * Dh * n_kv, H100_BF16_FLOPS)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Lc, device=DEV)[None, :]
            < kv_len[:, None])[:, None, None, :]
    call = lambda: da.decode_attention(q, k, v, kv_len)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    call()
    rec = {"shape": sh, "Lc": Lc, "kv_len": n_kv,
           "n_split": dk.last_n_split.value, "ms": cuda_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: dr.decode_attention_ref(
               q, k, v, kv_len)),
           "library_ms": cuda_ms(torch, sdpa), "bound_ms": b_ms,
           "bound_by": b_by}
    check(rec["n_split"] > 0,
          f"[timing] decode_attention Dh 112: last_n_split "
          f"{rec['n_split']}; the timed call must take the fast kernel")
    rec.update(decode_device_ms(torch, call, "decode_attention Dh 112"))
    rec.update(library_device_ms(torch, sdpa))
    out[f"decode_attention/zamba2/{Lc}/{n_kv}"] = rec
    log(f"[timing] decode_attention Dh 112 B={B} H={H}/{H} Lc={Lc} "
        f"kv_len={n_kv}: kernel {rec['ms']:.4f} ms (CUDA events), "
        + ("device not measured" if rec["device_ms"] is None else
           f"{rec['device_ms']:.4f} ms on the device "
           f"({b_ms / rec['device_ms']:.3f} of the bound)")
        + f", plain {rec['plain_ms']:.4f} ms, library "
        f"{rec['library_ms']:.4f} ms ({rec['library_device_ms']} ms on the "
        f"device), bound {b_ms:.4f} ms ({b_by}); last_n_split "
        f"{rec['n_split']} (the fast kernel's splits); device kernels "
        f"{rec['device_kernels']}")
    return out


def phase_ssm_hybrid(torch, np, recorders, seed: int) -> dict:
    """Phase 12: rwkv6-7b (``ssm_rwkv6``) and zamba2-7b (``ssm_zamba2``)
    at full size, each freed before the next, their K4, K3 and WKV6 calls
    noted by ``recorders`` (three OpsRecorders); every distinct WKV6 call
    of the engine runs held against the plain loop at its own arguments
    (the K3/K4 calls go to the re-checks with the other phases'). WKV6 at
    rwkv6's prefill and K4/K3 at zamba2's head dim 112 are timed in the
    timing child (``timing_child``)."""
    from repro_torch.models import layers as L, lm, ssm as S
    t0 = time.perf_counter()
    agree = Agreement()
    rwkv = ssm_rwkv6(torch, np, L, lm, S, recorders, agree, seed)
    gc.collect()
    torch.cuda.empty_cache()
    zamba = ssm_zamba2(torch, np, L, lm, S, recorders, agree, seed)
    gc.collect()
    torch.cuda.empty_cache()
    calls = sorted(c[1:] for c in recorders[2].distinct())
    err = max(compare_wkv6(torch, shape, dt, carried, seed + 60 + i)
              for i, (shape, dt, carried) in enumerate(calls))
    check({c[2] for c in calls} == {False, True}
          and any(c[0][1] > 1 for c in calls),
          f"[ssm] the WKV6 calls {calls} lack a prefill or a decode")
    kinds = ", ".join(f"{s} {d} {'carried' if c else 'zero'} state"
                      for s, d, c in calls)
    log(f"[ssm] {len(calls)} distinct WKV6 calls of the engine ({kinds}) "
        f"agree with the plain loop at their own arguments (within "
        f"{WKV6_RTOL} of the largest; max abs err {err:.3g})")
    launches = dict.fromkeys(ATT_KEYS, 0)
    for k, v in zamba["launches"].items():
        launches[k] += v
    launches["wkv6"] = rwkv["launches"]
    wall = time.perf_counter() - t0
    log(f"[ssm] phase done in {wall:.1f} s; launches {launches}")
    log_agreement("K3/K4 calls of the held bf16 runs, each on its own "
                  "inputs,", agree)
    return {"rwkv6-7b": rwkv, "zamba2-7b": zamba, "wkv6_calls": calls,
            "wkv6_max_abs_err": max(err, rwkv["wkv6_err"]),
            "agreement": agree, "launches": launches, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

# the backward kernels against attention_bwd_ref: f32 within BWD_RTOL_F32 of
# the plain version's largest |gradient| (fp32 FMAs summed in another
# order); bf16 within 2^-7 |plain| + BWD_ROW_RTOL x the row's rms of the
# root sum of squares of the gradient's terms (ref.attention_bwd_rss): P
# and dS are rounded to bf16 as tensor-core operands (about 2^-9 each, of
# random sign), and a gradient row can cancel to 0 where its terms do not
BWD_RTOL_F32 = 1e-5
BWD_ROW_RTOL = 2.0 ** -5
BWD_TIMED = dict(B=1, Lq=4096, Lkv=4096, H=40, Hkv=8, Dh=128)  # qwen3-14b
BWD_EMBED = dict(B=48, Lq=24, Lkv=24, H=12, Hkv=12, Dh=64)     # embedder
BWD_FAULT_TILE = (64, 128)   # the kv tile each planted fault drops (the
                             # f32 tiled pair's (a) tile at DP <= 128)
BWD_FAULT_F32_KEYS = 32      # the keys of one f32 tiled (b) CTA, whose dK
                             # rows its fault zeroes (from BWD_FAULT_TILE[0];
                             # also (a)'s key tile past head dim 128)
BWD_FAULT_KEYS = (8, 16)     # the keys it drops where Lkv <= 64 (the
                             # one-pass kernel's calls)
# launch.train --reduced's attention (B 8 x 128 tokens, qwen3-14b reduced)
BWD_REDUCED = dict(B=8, Lq=128, Lkv=128, H=4, Hkv=4, Dh=16)
# (shape, mask) of (a): every mode at B 2, H 10/2, Dh 64; then head dims
# 64, 112 and 128 at G = 1, 5 and 8
BWD_SWEEP = tuple(
    (dict(B=2, Lq=lq, Lkv=lkv, H=10, Hkv=2, Dh=64), kw) for lq, lkv, kw in (
        (200, 200, dict(causal=True)),
        (150, 150, dict(causal=False)),
        (300, 300, dict(causal=True, window=70)),
        (260, 260, dict(causal=True, prefix_len=96)),
        (77, 190, dict(causal=False)),                  # cross attention
        (100, 230, dict(causal=True, q_offset=40)),
        (90, 90, dict(causal=True, q_offset=-20)))      # masked rows
) + tuple((dict(B=1, Lq=129, Lkv=129, H=2 * G, Hkv=2, Dh=d),
           dict(causal=True)) for d in (64, 112, 128) for G in (1, 5, 8))
# (shape, mask) of (a)'s one-tile calls, which f32 sends to the one-pass
# kernel (Lq, Lkv <= 64; its 32-row tile where both are at most 32): every
# mode at B 3, H 10/2, Dh 64; then head dims 16-128 at G = 1, 5 and 8
BWD_SHORT_SWEEP = tuple(
    (dict(B=3, Lq=lq, Lkv=lkv, H=10, Hkv=2, Dh=64), kw) for lq, lkv, kw in (
        (24, 24, dict(causal=True)),
        (24, 24, dict(causal=False)),
        (57, 57, dict(causal=True)),
        (60, 60, dict(causal=True, window=9)),
        (40, 40, dict(causal=True, prefix_len=13)),
        (13, 37, dict(causal=False)),                   # cross attention
        (50, 20, dict(causal=False)),
        (10, 31, dict(causal=True, q_offset=21)),
        (30, 30, dict(causal=True, q_offset=-7)),       # masked rows
        (64, 48, dict(causal=True, window=16, q_offset=-20)))
) + tuple((dict(B=2, Lq=L, Lkv=L, H=2 * G, Hkv=2, Dh=d), dict(causal=True))
          for d in (16, 64, 100, 112, 128) for G in (1, 5, 8)
          for L in (31, 64))

# the backward's widths past Dq = Dv <= 128, (Dq, Dv): the MLA pairs of
# minicpm3-4b, deepseek-v2-236b and launch.train --reduced, (64, 128), and
# paligemma-3b's 256 and 160; in bf16 the wgmma pair takes (96, 64), (24,
# 16) and (64, 128), the wide wgmma pair those past 128 (its instance <192,
# 128> (192, 128), <256, 256> 256 and 160)
BWD_WIDTHS = ((96, 64), (192, 128), (24, 16), (64, 128), (256, 256),
              (160, 160))
# (shape, mask) of (a) at those widths: every mode at B 2, H 8/2, in f32
# and bf16; then each width's one-pass calls in f32 (13 and 31 tokens)
BWD_WIDTH_SWEEP = tuple(
    (dict(B=2, Lq=lq, Lkv=lkv, H=8, Hkv=2, Dh=dq, Dv=dv), kw)
    for dq, dv in BWD_WIDTHS for lq, lkv, kw in (
        (200, 200, dict(causal=True)),
        (150, 150, dict(causal=False)),
        (300, 300, dict(causal=True, window=70)),
        (260, 260, dict(causal=True, prefix_len=96)),
        (77, 190, dict(causal=False)),
        (100, 230, dict(causal=True, q_offset=40)),
        (90, 90, dict(causal=True, q_offset=-20))))
BWD_WIDTH_SHORT = tuple(
    (dict(B=2, Lq=L, Lkv=L, H=8, Hkv=1, Dh=dq, Dv=dv), dict(causal=True))
    for dq, dv in BWD_WIDTHS for L in (13, 31))
# the new modes at the main path's widths, bf16 B 1 x 4,096, causal (each
# also timed there): minicpm3-4b's 40 heads of (96, 64); paligemma-3b's 8
# query heads and 1 kv head of 256 with its 256-token image prefix, at the
# 4,352 tokens (256 patches and 4,096 text tokens) of phase 13 (b)'s step;
# deepseek-v2-236b's 128 heads of (192, 128), held at 1,024 tokens (its
# training step does not fit the card: phase 11 serves 4 of its 60 layers)
BWD_MLA = dict(B=1, Lq=4096, Lkv=4096, H=40, Hkv=40, Dh=96, Dv=64)
BWD_PALIGEMMA = dict(B=1, Lq=4352, Lkv=4352, H=8, Hkv=1, Dh=256)
BWD_PALIGEMMA_MASK = dict(causal=True, prefix_len=256)
BWD_DEEPSEEK = dict(B=1, Lq=4096, Lkv=4096, H=128, Hkv=128, Dh=192, Dv=128)
# K5-bwd (B, L, H, K) of (a) in f32 and bf16, each with and without a
# final-state cotangent and a carried state; rwkv6-7b's 64 heads of 64 at
# (b)'s 4,096 tokens with the planted fault; timed there too
WKV6_BWD_SWEEP = ((2, 1, 3, 64), (2, 17, 3, 64), (1, 100, 2, 16),
                  (2, 33, 2, 40), (3, 50, 2, 24), (2, 33, 2, 17),
                  (1, 300, 4, 64))
WKV6_BWD_HELD = dict(B=1, L=4096, H=64, K=64)
WKV6_BWD_TIMED = dict(B=1, L=4096, H=64, K=64)
WKV6_BWD_ROUNDS = 4     # timing rounds, alternating order
WKV6_CKPT_RTOL = 1e-6   # K5's checkpoints against wkv6_ckpt_ref's, of the
                        # largest |state| (f32 updates, FMA against a
                        # product and a sum)
WKV6_BWD_RTOL = 1e-5    # of each gradient's largest |gradient|; dr, dk and
                        # dv in bf16 also 2^-7 |plain| (both round them)

TRAIN_ARCH = "qwen3-14b"
# (b)'s other kinds at full width: MLA, the VLM prefix-LM at head dim 256,
# the SSM (WKV6), the two other dense kinds, the MoE with its window, the
# hybrid (Dh 112, Mamba2's SSD, the shared block's LoRA), the
# encoder-decoder (cross-attention's backward); each cut to TRAIN_LAYERS
# layers, or TRAIN_LAYERS_FOR's
TRAIN_KINDS = ("minicpm3-4b", "paligemma-3b", "rwkv6-7b", "qwen2.5-14b",
               "command-r-35b", "mixtral-8x7b", "zamba2-7b", "whisper-base")
TRAIN_PLAIN_SEQ = {"rwkv6-7b": 1024}    # the plain WKV6 loop's autograd
                                        # keeps every step's state
# (c): launch.train --reduced for every kind whose backward phase 13 runs
REDUCED_ARCHS = ("qwen3-14b", "minicpm3-4b", "deepseek-v2-236b",
                 "paligemma-3b", "rwkv6-7b", "qwen2.5-14b", "command-r-35b",
                 "mixtral-8x7b", "zamba2-7b", "whisper-base")
TRAIN_LAYERS = 4     # of 40: 2.88 B params, 34.5 GB with bf16 grads and
                     # f32 moments; all 40 would be about 177 GB
# other depths (0: the whole model), each from the dry-run's peak on one
# device (launch/dryrun.run_cell, B 1 x the kind's tokens): command-r-35b
# 2 of 40 (3.5 B params, its tied embedding 2.1 B of them: 54.8 GiB; 4
# layers would be 70.6), mixtral-8x7b 2 of 32 (3.2 B: 38.9 GiB; 3 would
# be 55.1), zamba2-7b 12 of 81 (the shared block's two invocations, each
# LoRA trained: 18.3 GiB), whisper-base whole (0: its 6 + 6 layers)
TRAIN_LAYERS_FOR = {"command-r-35b": 2, "mixtral-8x7b": 2, "zamba2-7b": 12,
                    "whisper-base": 0}
TRAIN_SEQ = 4096     # train_4k's sequence length, B 1
# mixtral past its 4,096-token window, so the window masks keys in the
# backward
TRAIN_SEQ_FOR = {"mixtral-8x7b": 4608}
TRAIN_CE_CHUNK = 512
TRAIN_STEPS = 4
TRAIN_LR = 3e-3      # warmup 1, as the reference's tiny train
                     # (tests/test_models.py:115)
# rwkv6-7b's 4 steps take launch.train's learning rate for a full-size
# model: its gradient norm is about 740 (qwen3's 9.5; the bonus u and the
# decay take the largest), and at 3e-3 AdamW's fourth step on the fixed
# batch overshot (losses 11.95, 9.51, 9.11, 14.03) after its held step had
# matched the plain one within the limits
TRAIN_LR_FOR = {"rwkv6-7b": 3e-4}
# one step's loss, global grad norm and per-leaf gradients against the same
# step with every attention call plain (written before the first run):
# K4's bf16 output sits within 2^-5 of a row's rms of the plain one, and the
# backward's bf16 operands within 2^-9; through 4 bf16 layers a leaf's
# gradient moves by a few bf16 ulps (2^-8) of its largest
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-2
TRAIN_GRAD_RTOL = 0.05
# A leaf whose exact gradient is 0 (whisper's cross-attention key bias: it
# shifts every score of a row alike, which the softmax ignores) reads
# rounding noise in both steps, so its difference is held as
# tests/test_torch_train_grads.py holds it (ZERO_FLOOR): where the plain
# step's leaf is below TRAIN_ZERO_FLOOR of the tree's largest |gradient|,
# the kernel step's must be too. Set before the first run on the card from
# tools/whisper_bwd_rounding.py (the kernels' rounding emulated on the
# CPU) at whisper's B 1 x 4,096: the plain step's 6.2e-6 to 1.5e-5, the
# backward with D from the bf16 output 5.5e-5 to 1.6e-4, with D =
# rowsum(P dP) 1.0e-5 to 1.6e-5
TRAIN_ZERO_FLOOR = 2.0 ** -14
# the traced step's device busy ms of an earlier run of (b) (NVIDIA H100
# 80GB HBM3 at 700.00 W), logged beside this run's
EARLIER_BUSY_MS = {"minicpm3-4b": (95.270, "before the exact-width pair")}
EMBED_TRAIN_STEPS = 60


def bwd_inputs(torch, shape: dict, dtype, seed: int, **kw):
    """q, k, v (v of ``shape["Dv"]`` where given), the plain forward's
    output o (contiguous, as K4's) and a seeded cotangent do."""
    from repro_torch.kernels.flash_attention import ref
    q, k, v = flash_inputs(torch, **shape, dtype=dtype, seed=seed)
    o = ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw).contiguous()
    do = torch.randn(o.shape, generator=gen(torch, seed + 1),
                     device=DEV).to(dtype)
    return q, k, v, o, do


def bwd_excess(torch, got, plain, rss) -> float:
    """The largest error of the three gradients over its limit (f32:
    BWD_RTOL_F32 of the largest |plain|; bf16: ``kernels.bf16_excess``
    with the terms' root sum of squares)."""
    from repro_torch.kernels import bf16_excess
    if got[0].dtype == torch.float32:
        return max(float((a - b).abs().max())
                   / (BWD_RTOL_F32 * float(b.abs().max()))
                   for a, b in zip(got, plain))
    return max(bf16_excess(a, b, BWD_ROW_RTOL, scale=r)
               for a, b, r in zip(got, plain, rss))


def bwd_key(torch, dtype, route: str, Dq: int, Dv: int) -> str:
    """The kernels-line family a backward call belongs to: ``one_pass``;
    ``float32`` (the f32 tiled pair); in bf16 ``bfloat16`` (the wgmma pair
    at Dv = Dq), ``dv`` (the wgmma pair at Dv != Dq), ``wide`` and
    ``wide192`` (the wide wgmma pair's instances <256, 256> and <192,
    128>)."""
    if route == "one_pass":
        return "one_pass"
    if dtype == torch.float32:
        return "float32"
    if route == "tiled_wide":
        return "wide192" if Dq <= 192 and Dv <= 128 else "wide"
    return "dv" if Dv != Dq else "bfloat16"


BWD_KEYS = ("float32", "bfloat16", "one_pass", "dv", "wide", "wide192")
# (a)'s ragged calls, kv_valid_len [L, L // 2 + 5, 0] (a full row, one that
# ends inside a tile, one of 0), causal and with a 19-token prefix: each
# backward family (the one-pass kernel, the f32 tiled pair, the wgmma pair
# at Dv = Dq and at (96, 64), the wide pair at (192, 128) and 256)
BWD_RAGGED = (
    ("float32", dict(B=3, Lq=40, Lkv=40, H=8, Hkv=2, Dh=64)),
    ("float32", dict(B=3, Lq=200, Lkv=200, H=8, Hkv=2, Dh=64)),
    ("bfloat16", dict(B=3, Lq=300, Lkv=300, H=8, Hkv=2, Dh=128)),
    ("bfloat16", dict(B=3, Lq=300, Lkv=300, H=8, Hkv=2, Dh=96, Dv=64)),
    ("bfloat16", dict(B=3, Lq=300, Lkv=300, H=8, Hkv=2, Dh=192, Dv=128)),
    ("bfloat16", dict(B=3, Lq=300, Lkv=300, H=8, Hkv=1, Dh=256)))


def bwd_compare(torch, res: dict, shape: dict, dtype, seed: int,
                fault: bool = False, **kw) -> None:
    """The backward kernels on seeded inputs against attention_bwd_ref;
    with ``fault``, also the kernels' output as it would be without one kv
    tile in (a)'s pass 2 and without one kv tile's (b) CTA (BWD_FAULT_TILE;
    on the f32 tiled pair (b)'s CTA is BWD_FAULT_F32_KEYS keys, and so is
    (a)'s tile past head dim 128; for the one-pass kernel's calls, Lkv <=
    64: without BWD_FAULT_KEYS in dQ's sum and with those rows of dK
    zeroed), each of which must fail the limit against the plain version;
    every f32 call and those at a width past Dq = Dv <= 128 run twice and
    must repeat bit for bit. Notes
    the largest |kernel - plain| of dq and of dk/dv, the largest share of
    the limit and the calls in ``res``, by ``bwd_key``. With a ragged
    ``kv_valid_len`` in ``kw``, dk and dv must be zero at and past each
    row's end, and the plain version without it (a kernel that ignored
    it) must fail the limit (noted in ``res["ragged"]``). At the class
    whose forward saves the LSE (``ops.saves_lse``: minicpm3's (96, 64))
    the call checked is the main path's, from the LSE of K4's training
    forward on q, k, v (``bwd_saved_lse``), held against the plain
    version from that LSE (D from the bf16 o, as that route forms it); the
    call without one (pass 1) must meet the same limit against the plain
    version without it (D = rowsum(P dP)), and with ``fault`` the backward
    from the LSE of other inputs must fail it."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, o, do = bwd_inputs(torch, shape, dtype, seed, **kw)
    got = ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    Dq, Dv = shape["Dh"], shape.get("Dv", shape["Dh"])
    route = ops.bwd_route(dtype, shape["Lq"], shape["Lkv"], Dq, Dv)
    dt = bwd_key(torch, dtype, route, Dq, Dv)
    kvl = kw.get("kv_valid_len")
    shown = kw if kvl is None else dict(kw, kv_valid_len=kvl.tolist())
    ctx = f"[train] backward {shape} {_dtype_name(dtype)} {shown} ({route})"
    lse, pass1 = None, None
    if ops.saves_lse(dtype, Dq, Dv):
        lse = bwd_saved_lse(torch, res, q, k, v, kw, ctx)
        pass1 = got
        got = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        torch.cuda.synchronize()
    if dtype == torch.float32 or Dv != Dq or Dq > 128:
        again = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{ctx}: two calls differ")
        del again
    # each route against the plain version of its own recurrence: from a
    # saved LSE, D = rowsum(do . o) from the bf16 o; with pass 1, rowsum(P
    # dP)
    plain = ref.attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    rss = ref.attention_bwd_rss(q, k, v, o, do, **kw)
    for g in got:
        check(bool(torch.isfinite(g).all()), f"{ctx}: non-finite gradient")
    x = bwd_excess(torch, got, plain, rss)
    res["share"][dt] = max(res["share"][dt], x)
    res["calls"][dt] += 1
    if pass1 is not None:
        x1 = bwd_excess(torch, pass1,
                        ref.attention_bwd_ref(q, k, v, o, do, **kw), rss)
        res["lse"]["pass1_share"] = max(res["lse"]["pass1_share"], x1)
        check(x1 <= 1.0, f"{ctx}: without a saved LSE (pass 1) {x1:.3g} of "
                         f"the limit")
        del pass1
    err = res["err"][dt]
    err["dq"] = max(err["dq"], float(
        (got[0].float() - plain[0].float()).abs().max()))
    err["dkv"] = max(err["dkv"], max(
        float((a.float() - b.float()).abs().max())
        for a, b in zip(got[1:], plain[1:])))
    res["n"] += 1
    check(x <= 1.0, f"{ctx}: {x:.3g} of the limit")
    if kvl is not None:
        for b, n in enumerate(kvl.tolist()):
            check(bool((got[1][b, n:] == 0).all()
                       and (got[2][b, n:] == 0).all()),
                  f"{ctx}: dk or dv of row {b} not zero past its {n} keys")
        unmasked = {n: a for n, a in kw.items() if n != "kv_valid_len"}
        f = bwd_excess(torch, got, ref.attention_bwd_ref(q, k, v, o, do,
                                                         **unmasked), rss)
        res["ragged"].append({"shape": shape, "dtype": dt, **shown,
                              "share": x, "kv_valid_len_ignored": f})
        check(f > 1.0, f"{ctx}: the plain version without kv_valid_len "
                       f"stays within the limit ({f:.3g})")
    if not fault:
        return
    t0, t1 = BWD_FAULT_TILE if shape["Lkv"] > 64 else BWD_FAULT_KEYS
    k1 = t1             # the end of the dK rows the fault zeroes
    if route == "tiled" and dtype == torch.float32:
        k1 = t0 + BWD_FAULT_F32_KEYS
        if max(Dq, Dv) > 128:
            t1 = k1
    p, dp, dsum, _, _, scale = ref._bwd_terms(
        q, k, v, o, do, kw.get("causal", True), kw.get("window"),
        kw.get("prefix_len", 0), kw.get("q_offset"))
    part = torch.einsum("bhgqk,bkhd->bqhgd", (p * (dp - dsum))[..., t0:t1],
                        k[:, t0:t1].float())
    dq_fault = (got[0].float() - part.reshape(q.shape) * scale).to(dtype)
    dk_fault = got[1].clone()
    dk_fault[:, t0:k1] = 0
    del p, dp, dsum, part
    fa = bwd_excess(torch, (dq_fault, got[1], got[2]), plain, rss)
    fb = bwd_excess(torch, (got[0], dk_fault, got[2]), plain, rss)
    res["faults"].append({"shape": shape, "dtype": dt, "keys": (t0, t1),
                          "dk_rows": (t0, k1),
                          "dq_tile_dropped": fa, "dkv_tile_dropped": fb})
    check(fa > 1.0 and fb > 1.0,
          f"{ctx}: dropped keys {t0}-{t1} (dk rows {t0}-{k1}) stay within "
          f"the limit (dq {fa:.3g}, dk {fb:.3g})")
    if lse is not None:
        q2 = q.clone()
        q2[..., 4] += 1
        other = bwd_saved_lse(torch, None, q2, k, v, kw, ctx)
        fl = bwd_excess(torch, ops.flash_attention_bwd(
            q, k, v, o, do, lse=other, **kw), plain, rss)
        res["faults"][-1]["other_lse"] = fl
        check(fl > 1.0, f"{ctx}: the backward from the LSE of other inputs "
                        f"stays within the limit ({fl:.3g})")


# the LSE K4's training forward writes against ``ref.attention_lse``, in
# log2 units: f32 sums of f32 products of the same bf16 values in another
# order, ex2 on the SFU (2^-22 relative); one 2^-10 moves P by 0.07%
BWD_LSE_ATOL = 2.0 ** -10


def bwd_saved_lse(torch, res, q, k, v, kw, ctx: str):
    """K4's training forward (``flash_bf16_persistent_lse``) at q, k, v
    and the mask ``kw``: its output must be the serving kernel's, bit for
    bit, its LSE within BWD_LSE_ATOL of ``ref.attention_lse``'s (+inf
    exactly where the plain one is). Notes the largest difference in
    ``res["lse"]`` (unless ``res`` is None); returns the LSE."""
    from repro_torch.kernels.flash_attention import ops, ref
    mask = dict(causal=kw.get("causal", True), window=kw.get("window"),
                prefix_len=kw.get("prefix_len", 0),
                q_offset=kw.get("q_offset"),
                kv_valid_len=kw.get("kv_valid_len"))
    if mask["q_offset"] is None:
        mask["q_offset"] = k.shape[1] - q.shape[1]
    out, lse = ops._forward(q, k, v, *mask.values(), with_lse=True)
    served = ops._forward(q, k, v, *mask.values())
    torch.cuda.synchronize()
    check(torch.equal(out, served), f"{ctx}: K4's output moves with the "
                                    f"LSE write")
    plain = ref.attention_lse(q, k, **mask)
    inf = torch.isposinf(plain)
    check(torch.equal(torch.isposinf(lse), inf),
          f"{ctx}: the LSE is +inf at other rows than the plain one's")
    err = float((lse - plain)[~inf].abs().max()) if bool((~inf).any()) \
        else 0.0
    check(err <= BWD_LSE_ATOL, f"{ctx}: K4's LSE {err:.3g} from the plain "
                               f"one")
    if res is not None:
        res["lse"]["err"] = max(res["lse"]["err"], err)
        res["lse"]["calls"] += 1
    del out, served, plain
    return lse


def wkv6_bwd_excess(torch, got, plain) -> float:
    """The largest error of K5-bwd's six gradients over its limit:
    WKV6_BWD_RTOL of the gradient's largest |plain|, plus 2^-7 |plain|
    where both round it to bf16."""
    from repro_torch.kernels import BF16_RTOL
    out = 0.0
    for a, b in zip(got, plain):
        rounded = a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        lim = WKV6_BWD_RTOL * float(b.abs().max()) + (
            BF16_RTOL * b.abs() if rounded else 0)
        d = (a - b).abs()
        if float(d.max()):
            out = max(out, float((d / lim).max()))
    return out


def wkv6_bwd_inputs(torch, B, L, H, K, dtype, carried: bool, seed: int):
    """``wkv6_inputs``' r, k, v, w, u, state, with seeded cotangents dy (B,
    L, H, K) and ds (B, H, K, K) f32."""
    xs = wkv6_inputs(torch, B, L, H, K, dtype, carried, seed)
    g = gen(torch, seed + 1)
    dy = torch.randn((B, L, H, K), generator=g, device=DEV)
    ds = torch.randn((B, H, K, K), generator=g, device=DEV)
    return xs, dy, ds


def wkv6_bwd_compare(torch, res: dict, B, L, H, K, dtype, cot: bool,
                     seed: int, fault: bool = False) -> None:
    """K5-bwd on seeded inputs (a carried state; the final state's
    cotangent with ``cot``) against ``wkv6_bwd_ref`` through both routes:
    from the checkpoints K5 writes (``WKV6Fn``'s forward, here
    ``ops._forward(..., ckpt=True)``) and given none (the call runs the
    checkpointing K5 itself), twice from the saved ones, all three
    bit-identical. K5's y and final state must be the same bits with and
    without checkpoint writes, and its checkpoints within WKV6_CKPT_RTOL
    of the largest |state| of ``wkv6_ckpt_ref``'s. With ``fault``, the
    plain backward with the cotangent of one step's y dropped, and the
    kernel given checkpoints of other inputs (the state carried in moved
    by 1), must each fail the limit."""
    from repro_torch.kernels.wkv6 import ops, ref
    xs, dy, ds = wkv6_bwd_inputs(torch, B, L, H, K, dtype, True, seed)
    ds = ds if cot else None
    ctx = f"[train] K5-bwd B {B} L {L} H {H} K {K} {_dtype_name(dtype)} " \
          f"final-state cotangent {cot}"
    y0, s0 = ops.wkv6(*xs)
    y1, s1, ck = ops._forward(*xs, ckpt=True)
    check(torch.equal(y0, y1) and torch.equal(s0, s1),
          f"{ctx}: K5's y or final state moves with checkpoint writes")
    want = ref.wkv6_ckpt_ref(xs[1], xs[2], xs[3], xs[5])
    ck_err = float((ck - want).abs().max())
    check(ck_err <= WKV6_CKPT_RTOL * float(want.abs().max()),
          f"{ctx}: K5's checkpoints {ck_err:.3g} from the plain ones")
    res["ckpt_err"] = max(res["ckpt_err"], ck_err)
    del y0, s0, y1, s1, want
    got = ops.wkv6_bwd(*xs, dy, ds, ckpt=ck)
    again = ops.wkv6_bwd(*xs, dy, ds, ckpt=ck)
    none = ops.wkv6_bwd(*xs, dy, ds)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) and torch.equal(a, c)
              for a, b, c in zip(got, again, none)),
          f"{ctx}: two calls, or the saved checkpoints and none, differ")
    del again, none
    for t in got:
        check(bool(torch.isfinite(t).all()), f"{ctx}: non-finite gradient")
    plain = ref.wkv6_bwd_ref(*xs, dy, ds)
    x = wkv6_bwd_excess(torch, got, plain)
    res["share"] = max(res["share"], x)
    res["err"] = max(res["err"], max(float((a.float() - b.float()).abs()
                                           .max()) for a, b in zip(got,
                                                                   plain)))
    res["n"] += 1
    check(x <= 1.0, f"{ctx}: {x:.3g} of the limit")
    if fault:
        faulty = dy.clone()
        faulty[:, L // 2] = 0
        f = wkv6_bwd_excess(torch, got, ref.wkv6_bwd_ref(*xs, faulty, ds))
        other = ops._forward(*xs[:5], xs[5] + 1.0, ckpt=True)[2]
        fc = wkv6_bwd_excess(torch, ops.wkv6_bwd(*xs, dy, ds, ckpt=other),
                             plain)
        res["fault"] = {"shape": (B, L, H, K), "dy_step_dropped": L // 2,
                        "share": f, "other_checkpoints": fc}
        check(f > 1.0, f"{ctx}: the plain backward without step {L // 2}'s "
                       f"dy stays within the limit ({f:.3g})")
        check(fc > 1.0, f"{ctx}: checkpoints of other inputs stay within "
                        f"the limit ({fc:.3g})")


def train_kernels(torch, seed: int) -> dict:
    """(a): the backward kernels against their plain version over
    BWD_SWEEP in f32 and bf16, at qwen3-14b's 4,096-token prefill in bf16
    and at 1,024 tokens in f32 (the tiled pair), over BWD_SHORT_SWEEP in
    f32 (the one-pass kernel), and at the shapes (c)'s trainers give them
    (the embedder's in f32, one pass; the reduced qwen3's in bf16); the
    planted faults at 256 tokens, at 4,096 and at both trainers' shapes.
    The widths past Dq = Dv <= 128 over BWD_WIDTH_SWEEP in f32 and bf16
    and BWD_WIDTH_SHORT in f32, each call twice and bit-identical, with a
    planted fault at each width at 256 tokens; at minicpm3-4b's and
    paligemma-3b's calls of (b) (BWD_MLA, BWD_PALIGEMMA) and at
    deepseek-v2's 128 heads of (192, 128) at 1,024 tokens in bf16, each
    with its fault. Every family with a ragged kv_valid_len (BWD_RAGGED),
    with its fault (the plain version without it). K5-bwd over
    WKV6_BWD_SWEEP in f32 and bf16, and at WKV6_BWD_HELD with its fault.
    The backward's counters are zeroed before and read after: the tiled
    f32 pair's launches and the wide pair's <192, 128> instance's
    (deepseek-v2's) here are their ``sweep_launches`` on the kernels line,
    whose ``launches`` (the main path's) are 0 for them."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    fa.flash_attention.launches_bwd = fa.flash_attention.launches_bwd_f32 \
        = fa.flash_attention.launches_bwd_f32_one_pass \
        = fa.flash_attention.launches_bwd_dv \
        = fa.flash_attention.launches_bwd_exact \
        = fa.flash_attention.launches_bwd_wide = 0
    wkv6_ops.wkv6.launches_bwd = wkv6_ops.wkv6.launches_ckpt = 0
    res = {"err": {dt: {"dq": 0.0, "dkv": 0.0} for dt in BWD_KEYS},
           "share": {dt: 0.0 for dt in BWD_KEYS},
           "calls": {dt: 0 for dt in BWD_KEYS},
           "n": 0, "faults": [], "ragged": [],
           "lse": {"calls": 0, "err": 0.0, "pass1_share": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, kw) in enumerate(BWD_SWEEP):
            bwd_compare(torch, res, shape, dtype, seed + 300 + i, **kw)
        bwd_compare(torch, res, dict(B=1, Lq=256, Lkv=256, H=8, Hkv=2,
                                     Dh=128), dtype, seed + 340, fault=True,
                    causal=True)
        for i, (shape, kw) in enumerate(BWD_WIDTH_SWEEP):
            bwd_compare(torch, res, shape, dtype, seed + 500 + i, **kw)
        for i, (dq, dv) in enumerate(BWD_WIDTHS):
            bwd_compare(torch, res, dict(B=1, Lq=256, Lkv=256, H=8, Hkv=2,
                                         Dh=dq, Dv=dv), dtype,
                        seed + 560 + i, fault=True, causal=True)
    for i, (shape, kw) in enumerate(BWD_SHORT_SWEEP + BWD_WIDTH_SHORT):
        bwd_compare(torch, res, shape, torch.float32, seed + 350 + i, **kw)
    bwd_compare(torch, res, dict(BWD_TIMED, Lq=1024, Lkv=1024),
                torch.float32, seed + 341, causal=True)
    bwd_compare(torch, res, BWD_TIMED, torch.bfloat16, seed + 342,
                fault=True, causal=True)
    bwd_compare(torch, res, BWD_EMBED, torch.float32, seed + 343,
                fault=True, causal=False)
    bwd_compare(torch, res, BWD_REDUCED, torch.bfloat16, seed + 344,
                fault=True, causal=True)
    bwd_compare(torch, res, BWD_MLA, torch.bfloat16, seed + 345,
                fault=True, causal=True)
    bwd_compare(torch, res, BWD_PALIGEMMA, torch.bfloat16, seed + 346,
                fault=True, **BWD_PALIGEMMA_MASK)
    bwd_compare(torch, res, dict(BWD_DEEPSEEK, Lq=1024, Lkv=1024),
                torch.bfloat16, seed + 347, fault=True, causal=True)
    # the wide pair's (b) at <256, 256> with dK's and dV's columns whole:
    # 4 x 8 kv heads x 5 key tiles, 160 CTAs, more than the 132 SMs
    bwd_compare(torch, res, dict(B=4, Lq=300, Lkv=300, H=16, Hkv=8,
                                 Dh=256), torch.bfloat16, seed + 348,
                fault=True, causal=True, prefix_len=40)
    for i, (dt, shape) in enumerate(BWD_RAGGED):
        L = shape["Lkv"]
        kvl = torch.tensor([L, L // 2 + 5, 0], device=DEV)
        for j, mask in enumerate((dict(causal=True),
                                  dict(causal=True, prefix_len=19))):
            bwd_compare(torch, res, shape, getattr(torch, dt),
                        seed + 700 + 2 * i + j, kv_valid_len=kvl, **mask)
    one = fa.flash_attention.launches_bwd_f32_one_pass
    res["launches"] = {
        "one_pass": one,
        "tiled_f32": fa.flash_attention.launches_bwd_f32 - one,
        "tiled_bf16": fa.flash_attention.launches_bwd
        - fa.flash_attention.launches_bwd_f32,
        "tiled_dv": fa.flash_attention.launches_bwd_dv,
        "tiled_exact": fa.flash_attention.launches_bwd_exact,
        "tiled_wide": fa.flash_attention.launches_bwd_wide}
    check(one >= len(BWD_SHORT_SWEEP) and res["launches"]["tiled_f32"] > 0
          and all(res["calls"][dt] > 0 for dt in BWD_KEYS)
          and res["lse"]["calls"] > 0,
          f"[train] (a) backward launches by route {res['launches']}, calls "
          f"by family {res['calls']}")
    wkv = {"share": 0.0, "err": 0.0, "n": 0, "ckpt_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, L, H, K) in enumerate(WKV6_BWD_SWEEP):
            for cot in (False, True):
                wkv6_bwd_compare(torch, wkv, B, L, H, K, dtype, cot,
                                 seed + 600 + 2 * i + cot)
    wkv6_bwd_compare(torch, wkv, *(WKV6_BWD_HELD[x] for x in "BLHK"),
                     torch.bfloat16, True, seed + 620, fault=True)
    wkv["launches"] = wkv6_ops.wkv6.launches_bwd
    wkv["launches_ckpt"] = wkv6_ops.wkv6.launches_ckpt
    res["wkv6_bwd"] = wkv
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] (a) {res['n']} backward calls agree with the plain version "
        f"(f32 {BWD_RTOL_F32} of the largest |gradient|, largest share: "
        f"tiled {res['share']['float32']:.3g}, one-pass "
        f"{res['share']['one_pass']:.3g}; bf16 2^-7 |plain| + 2^-5 x the "
        f"row's rms of the terms' root sum of squares, largest share "
        f"{res['share']['bfloat16']:.3g}, Dv != Dq on the wgmma pair "
        f"{res['share']['dv']:.3g}, the wide pair at <256, 256> "
        f"{res['share']['wide']:.3g} and <192, 128> "
        f"{res['share']['wide192']:.3g}); max "
        f"abs err dq, dk/dv: " + ", ".join(
            f"{dt} {e['dq']:.3g}, {e['dkv']:.3g}"
            for dt, e in res["err"].items()) + f"; calls by family "
        f"{res['calls']}; launches by route {res['launches']}; one-pass "
        "and new-width repeats bit-identical; planted faults " + "; ".join(
            f"{f['dtype']} B {f['shape']['B']} L {f['shape']['Lq']} D "
            f"{f['shape']['Dh']}/{f['shape'].get('Dv', f['shape']['Dh'])} "
            f"keys {f['keys'][0]}-{f['keys'][1]}: dq "
            f"{f['dq_tile_dropped']:.3g}, dk {f['dkv_tile_dropped']:.3g} of "
            f"the limit" for f in res["faults"]))
    log(f"[train] (a) the exact-width pair <96, 64> from K4's saved LSE: "
        f"{res['lse']['calls']} calls, K4's output the same bits with the "
        f"LSE write, its LSE within {res['lse']['err']:.3g} of the plain "
        f"one (log2 units; limit {BWD_LSE_ATOL:.3g}); the same calls "
        f"without a saved LSE (pass 1) at most "
        f"{res['lse']['pass1_share']:.3g} of the limit; the backward from "
        f"the LSE of other inputs " + "; ".join(
            f"{f['other_lse']:.3g}" for f in res["faults"]
            if "other_lse" in f) + " of the limit")
    log("[train] (a) a ragged kv_valid_len on every family (share of the "
        "limit; the plain version without it): " + "; ".join(
            f"{r['dtype']} L {r['shape']['Lq']} D {r['shape']['Dh']}/"
            f"{r['shape'].get('Dv', r['shape']['Dh'])} prefix "
            f"{r.get('prefix_len', 0)}: {r['share']:.3g}, ignored "
            f"{r['kv_valid_len_ignored']:.3g}" for r in res["ragged"]))
    log(f"[train] (a) K5-bwd: {wkv['n']} calls agree with wkv6_bwd_ref "
        f"(1e-5 of each gradient's largest |gradient|, bf16 outputs also "
        f"2^-7 |plain|; largest share {wkv['share']:.3g}, max abs err "
        f"{wkv['err']:.3g}), from K5's checkpoints (twice) and from none, "
        f"the three bit-identical; {wkv['launches']} K5-bwd launches, "
        f"{wkv['launches_ckpt']} checkpointing K5 launches; K5's y and "
        f"state the same bits with checkpoint writes, its checkpoints "
        f"within {wkv['ckpt_err']:.3g} of the plain ones; planted faults "
        f"at {wkv['fault']['shape']}: dy of step "
        f"{wkv['fault']['dy_step_dropped']} dropped "
        f"{wkv['fault']['share']:.3g}, checkpoints of other inputs "
        f"{wkv['fault']['other_checkpoints']:.3g} of the limit")
    return res


def train_trace(torch, fn) -> dict:
    """``fn`` (one train step) under torch.profiler: the device's busy ms,
    the backward kernels' ms (``fab::bwd``, and K5-bwd's ``wkvb::``), K4's
    forward (``fa::flash_``) and K5's (``wkv::wkv6``) and their shares of
    it, the largest kernels. The profiled wall clock carries the
    profiler's own host cost; the caller sets the idle share against an
    untraced step's."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    tr = device_summary(prof, 1)
    if not tr:
        return {"profiled_wall_ms": wall}
    by = tr.pop("by_name_ms")
    bwd = {n.split("(")[0][:60]: t for n, t in by.items()
           if "fab::bwd" in n or "wkvb::" in n}
    k4 = sum(t for n, t in by.items() if "fa::flash_" in n)
    k5 = sum(t for n, t in by.items() if "wkv::wkv6" in n)
    return {"profiled_wall_ms": wall, **tr, "bwd_ms": bwd,
            "bwd_share": sum(bwd.values()) / tr["busy_ms"],
            "k4_ms": k4, "k4_share": k4 / tr["busy_ms"],
            "k5_ms": k5, "k5_share": k5 / tr["busy_ms"]}


def train_counts() -> dict:
    """The training path's kernel counters: K4-bwd's launches (every one,
    the f32 ones, the one-pass ones, the wgmma pair's Dv != Dq ones and of
    those the exact-width pair's, the wide bf16 pair's), K4's launches that
    write the LSE for it, K5's and K5-bwd's, and the plain attention
    backward's calls; K5's checkpointing launches (``wkv6_ckpt``) are
    among K5's."""
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    f = fa.flash_attention
    return {"flash_attention_bwd": f.launches_bwd,
            "flash_attention_bwd_f32": f.launches_bwd_f32,
            "flash_attention_bwd_f32_one_pass": f.launches_bwd_f32_one_pass,
            "flash_attention_bwd_dv": f.launches_bwd_dv,
            "flash_attention_bwd_exact": f.launches_bwd_exact,
            "flash_attention_bwd_wide": f.launches_bwd_wide,
            "flash_attention_lse": f.launches_lse,
            "wkv6": wkv6_ops.wkv6.launches,
            "wkv6_ckpt": wkv6_ops.wkv6.launches_ckpt,
            "wkv6_bwd": wkv6_ops.wkv6.launches_bwd,
            "plain_attention_bwd": fr.attention_bwd_ref.calls}


def zero_train_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa, ref as fr
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    f = fa.flash_attention
    f.launches_bwd = f.launches_bwd_f32 = f.launches_bwd_f32_one_pass = \
        f.launches_bwd_dv = f.launches_bwd_exact = f.launches_bwd_wide = \
        f.launches_lse = 0
    wkv6_ops.wkv6.launches = wkv6_ops.wkv6.launches_bwd = \
        wkv6_ops.wkv6.launches_ckpt = 0
    fr.attention_bwd_ref.calls = 0


def train_full(torch, np, arch: str, seed: int) -> dict:
    """(b): ``arch`` at full width cut as ``train_cfg`` cuts it, remat on,
    bf16 params: one step's loss, grad norm and gradients held against the
    same step with every attention call and every WKV6 recurrence plain
    (``swap_attention``), on B 1 x TRAIN_SEQ tokens (TRAIN_SEQ_FOR's where
    set; TRAIN_PLAIN_SEQ where set: rwkv6's plain loop keeps every step's
    state for autograd); an MoE kind's plain step is held with the kernel
    step's routing forced where a token's experts flipped (``routing``);
    then TRAIN_STEPS steps of ``make_train_step`` on one fixed batch, the
    last one traced. The kind's backward kernels must launch in the steps
    (K4-bwd twice an attention call a step, on the route its widths take;
    K5-bwd once a layer) and the plain attention backward never."""
    from repro_torch.launch import steps
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import layers as L, lm, ssm as S
    from repro_torch.training import optimizer as opt
    cfg = train_cfg(arch)
    params = lm.init_params(gen(torch, seed + 400), cfg, DEV)
    n_params = lm.n_params(params)
    rng = np.random.default_rng(seed + 401)
    seq = TRAIN_SEQ_FOR.get(arch, TRAIN_SEQ)
    batch = synth_batch(cfg, rng, 1, seq, DEV)
    held_seq = TRAIN_PLAIN_SEQ.get(arch, seq)
    held_batch = batch if held_seq == seq else \
        synth_batch(cfg, rng, 1, held_seq, DEV)

    def grads():
        return steps.value_and_grad(lambda p: steps.chunked_ce_loss(
            p, cfg, held_batch, TRAIN_CE_CHUNK)[0], params)
    with routing(L) as kr:
        loss_k, g_k = grads()
    if cfg.attn_every:
        # each invocation of the shared block trains its own LoRA (its
        # lora_b starts at zero, so lora_a's first gradient is zero)
        lora = g_k["shared_attn"]["lora_b"]
        got = [float(lora[i].abs().max()) for i in range(lora.shape[0])]
        check(len(got) >= 2 and all(g > 0 for g in got),
              f"[train] {arch}: the shared block's LoRA gradients by "
              f"invocation {got}")
        log(f"[train] (b) {arch}: the shared block ran {len(got)} times; "
            f"its LoRA's largest |gradient| by invocation "
            f"{[f'{g:.4g}' for g in got]}")
    with routing(L) as pr, swap_attention(L, S=S):
        loss_p, g_p = grads()
    flips = flip_shares(kr.idx, pr.idx)
    if any(flips):
        del g_p
        with routing(L, force=kr.idx), swap_attention(L, S=S):
            loss_p, g_p = grads()
        log(f"[train] (b) {arch}: routing flips per MoE call "
            f"{[round(x, 4) for x in flips]}; the plain step held with the "
            f"kernel step's routing forced")
    norm_k, norm_p = float(opt.global_norm(g_k)), float(opt.global_norm(g_p))
    worst, worst_leaf, zero = 0.0, None, {}
    tree = max(float(b.abs().max()) for _, b in opt.tree_leaves(g_p))
    for (path, a), (_, b) in zip(opt.tree_leaves(g_k), opt.tree_leaves(g_p)):
        top = float(b.abs().max())
        r = float((a.float() - b.float()).abs().max()) / top if top else \
            float(a.abs().max())
        name = "/".join(map(str, path))
        if r > TRAIN_GRAD_RTOL and top < TRAIN_ZERO_FLOOR * tree:
            zero[name] = (float(a.abs().max()) / tree, top / tree)
        elif r > worst:
            worst, worst_leaf = r, name
    del g_k, g_p
    held = {"loss": float(loss_k), "loss_plain": float(loss_p),
            "grad_norm": norm_k, "grad_norm_plain": norm_p,
            "worst_leaf": worst_leaf, "worst_leaf_rel": worst,
            "zero_leaves_of_tree": zero,
            "seq": held_seq, "routing_flip_share": flips}
    log(f"[train] (b) {arch} x {cfg.n_layers} layers ({n_params / 1e9:.2f} "
        f"B params, bf16, remat), B 1 x {held_seq}: one step with the "
        f"kernels against the plain attention and WKV6: loss "
        f"{held['loss']:.5f} vs {held['loss_plain']:.5f}, grad norm "
        f"{norm_k:.5f} vs {norm_p:.5f}, largest leaf difference {worst:.4g} "
        f"of its largest |gradient| ({worst_leaf})")
    if zero:
        log(f"[train] (b) {arch}: leaves at the plain step's rounding noise "
            f"(exact gradient 0), largest |gradient| of the tree's, kernels "
            f"vs plain (floor {TRAIN_ZERO_FLOOR:.3g}): " + "; ".join(
                f"{n} {k:.3g} vs {p:.3g}" for n, (k, p) in zero.items()))
    check(abs(held["loss"] - held["loss_plain"])
          <= TRAIN_LOSS_RTOL * abs(held["loss_plain"]),
          f"[train] {arch} loss {held['loss']} vs plain {held['loss_plain']}")
    check(abs(norm_k - norm_p) <= TRAIN_GNORM_RTOL * norm_p,
          f"[train] {arch} grad norm {norm_k} vs plain {norm_p}")
    check(worst <= TRAIN_GRAD_RTOL,
          f"[train] {arch} gradient leaf {worst_leaf} differs by {worst:.4g} "
          f"of its largest |gradient|")
    check(all(k < TRAIN_ZERO_FLOOR for k, _ in zero.values()),
          f"[train] {arch}: a leaf whose plain gradient is rounding noise is "
          f"above {TRAIN_ZERO_FLOOR:.3g} of the tree's largest with the "
          f"kernels: {zero}")
    del held_batch
    gc.collect()
    torch.cuda.empty_cache()
    state = opt.init_state(params)
    lr = TRAIN_LR_FOR.get(arch, TRAIN_LR)
    step = steps.make_train_step(cfg, optc=opt.AdamWConfig(
        lr=lr, warmup_steps=1, total_steps=30),
        ce_chunk=TRAIN_CE_CHUNK)
    before, att0 = train_counts(), attention_launches()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    losses, host_ms, tr = [], [], {}
    for i in range(TRAIN_STEPS):
        def one():
            nonlocal params, state
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            tr = train_trace(torch, one)
        else:
            one()
            torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(host_ms[:-1])
    if tr.get("busy_ms"):
        tr["idle_share"] = max(0.0, 1.0 - tr["busy_ms"] / step_ms)
    counts = {n: c - before[n] for n, c in train_counts().items()}
    att = {n: c - att0[n] for n, c in attention_launches().items()}
    log(f"[train] (b) {arch}: {TRAIN_STEPS} steps (lr {lr}, warmup "
        f"1), B 1 x {seq}: losses {[round(x, 5) for x in losses]}; "
        f"host ms a step {[round(x, 1) for x in host_ms]} (the last "
        f"profiled; median of the others {step_ms:.1f}); peak memory "
        f"{peak:.1f} GiB; kernel launches {counts}; forward attention "
        f"launches {att}")
    if tr.get("busy_ms"):
        log(f"[train] (b) {arch} traced step: wall "
            f"{tr['profiled_wall_ms']:.1f} ms, device busy "
            f"{tr['busy_ms']:.3f} ms (idle share {tr['idle_share']:.3f} of "
            f"an untraced step's {step_ms:.1f} ms; {tr['device_events']} "
            f"device events); backward kernels {tr['bwd_ms']} "
            f"({tr['bwd_share']:.4f} of busy), K4 forward "
            f"{tr['k4_ms']:.3f} ms ({tr['k4_share']:.4f}), K5 forward "
            f"{tr['k5_ms']:.3f} ms ({tr['k5_share']:.4f}); most device "
            "time: " + "; ".join(f"{n} {t:.3f} ms"
                                 for n, t in tr["top_kernels_ms"]))
        if arch in EARLIER_BUSY_MS:
            was, what = EARLIER_BUSY_MS[arch]
            log(f"[train] (b) {arch}: device busy {tr['busy_ms']:.3f} ms a "
                f"step against {was:.3f} ms {what}")
    else:
        log(f"[train] (b) {arch} traced step: no device activity recorded "
            "(not measured)")
    check(all(np.isfinite(losses)), f"[train] {arch} non-finite loss "
                                    f"{losses}")
    check(losses[-1] < losses[0], f"[train] {arch}: the loss did not fall: "
                                  f"{losses}")
    n = attention_calls(cfg) * TRAIN_STEPS
    if cfg.ssm_kind == "rwkv6":
        n = cfg.n_layers * TRAIN_STEPS
        need = {"wkv6": n, "wkv6_ckpt": n, "wkv6_bwd": n}
    else:
        route = {"mla": "flash_attention_bwd_dv"}.get(
            cfg.attn_kind, "flash_attention_bwd_wide" if cfg.head_dim > 128
            else "flash_attention_bwd")
        need = {"flash_attention_bwd": 2 * n, route: 2 * n}
        dq, dv = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) \
            if cfg.attn_kind == "mla" else (cfg.head_dim, cfg.head_dim)
        if fa.saves_lse(getattr(torch, cfg.dtype), dq, dv):
            # the forward's LSE, the exact pair
            need.update(flash_attention_lse=n,
                        flash_attention_bwd_exact=2 * n)
    check(all(counts[k] >= v for k, v in need.items()),
          f"[train] {arch}: kernel launches {counts} in {TRAIN_STEPS} steps "
          f"of {cfg.n_layers} layers, short of {need}")
    check(counts["plain_attention_bwd"] == 0,
          f"[train] {arch}: the plain attention backward ran "
          f"{counts['plain_attention_bwd']} times on the card")
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"n_params": n_params, "held": held, "losses": losses,
            "host_ms": host_ms, "step_ms": step_ms, "peak_gib": peak,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "alloc_before_bytes": alloc0, "layers": cfg.n_layers, "seq": seq,
            "trace": tr, "launches": counts, "attention_launches": att}


def train_cfg(arch: str):
    """``arch`` as phase 13 (b) trains it: full width, the depth cut to
    TRAIN_LAYERS (TRAIN_LAYERS_FOR's where set; 0 the whole model), remat
    on, bf16."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    layers = TRAIN_LAYERS_FOR.get(arch, TRAIN_LAYERS)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return cfg.replace(remat=True)


def attention_calls(cfg) -> int:
    """The attention calls in one forward of ``cfg``: one a layer, the
    hybrid's shared block once an invocation, the encoder-decoder's
    encoder layers once and decoder layers twice (self and cross)."""
    if cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    if cfg.is_encoder_decoder:
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def train_launchers(torch, np) -> dict:
    """(c): ``launch.train --reduced`` for each of REDUCED_ARCHS, 10 steps
    on the card (the loss decreases; the kind's backward kernel launches,
    the plain attention backward never), and ``launch.train_embedder`` at
    the full siso-embedder in f32 for
    EMBED_TRAIN_STEPS steps (f32 K4 forward and the one-pass backward
    kernel every step: 12 calls a step, two encodes of 6 layers), each
    step timed on the host and the last one traced (busy ms, idle share
    against the untraced steps' median, the backward's and K4's shares)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train, train_embedder
    t0 = time.perf_counter()
    reduced = {}
    for arch in REDUCED_ARCHS:
        before = train_counts()
        losses = train.run(["--arch", arch, "--reduced", "--steps", "10",
                            "--device", DEV])["losses"]
        first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        reduced[arch] = {"losses": losses, "launches": {
            n: c - before[n] for n, c in train_counts().items()}}
        check(last < first, f"[train] (c) launch.train --arch {arch} "
                            f"--reduced: the loss did not decrease: {losses}")
        bwd = "wkv6_bwd" if arch == "rwkv6-7b" else "flash_attention_bwd"
        check(reduced[arch]["launches"][bwd] >= 10
              and reduced[arch]["launches"]["plain_attention_bwd"] == 0,
              f"[train] (c) {arch}: launches {reduced[arch]['launches']}")
    lm_s = time.perf_counter() - t0
    losses = reduced[REDUCED_ARCHS[0]]["losses"]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    f32_0, one_0 = fa.flash_attention.launches_f32, \
        fa.flash_attention.launches_bwd_f32_one_pass
    host_ms, tr = [], {}

    def timed(i, run):
        t = time.perf_counter()
        if i == EMBED_TRAIN_STEPS - 1:
            out = []
            tr.update(train_trace(torch, lambda: out.append(run())))
            loss = out[0]
        else:
            loss = run()
            torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t))
        return loss
    t0 = time.perf_counter()
    emb = train_embedder.train(steps=EMBED_TRAIN_STEPS, full=True,
                               device=DEV, log_every=0, wrap_step=timed)
    emb_s = time.perf_counter() - t0
    (d0, n0), (d1, n1) = emb["before"], emb["after"]
    per_step = 2 * 6        # two encodes of the 6 shared layers
    f32 = fa.flash_attention.launches_f32 - f32_0
    one = fa.flash_attention.launches_bwd_f32_one_pass - one_0
    step_ms = statistics.median(host_ms[1:-1])    # past the first step
    if tr.get("busy_ms"):
        tr["idle_share"] = max(0.0, 1.0 - tr["busy_ms"] / step_ms)
    log("[train] (c) launch.train --reduced, 10 steps each: " + "; ".join(
        f"{a} loss {np.mean(r['losses'][:3]):.3f} -> "
        f"{np.mean(r['losses'][-3:]):.3f}, launches {r['launches']}"
        for a, r in reduced.items()) + f" ({lm_s:.1f} s in all)")
    log(f"[train] (c) launch.train --reduced: loss {first:.3f} -> {last:.3f} "
        f"in 10 steps ({lm_s:.1f} s); train_embedder (d 768, f32, "
        f"{EMBED_TRAIN_STEPS} steps, {emb_s:.1f} s, {step_ms:.2f} ms a step "
        f"on the host, median): gap {d0 - n0:+.3f} -> {d1 - n1:+.3f} (dup "
        f"{d1:.3f}, non-dup {n1:.3f}); f32 K4 launches {f32}, one-pass "
        f"backward launches {one}")
    if tr.get("busy_ms"):
        log(f"[train] (c) traced embedder step: wall "
            f"{tr['profiled_wall_ms']:.1f} ms, device busy "
            f"{tr['busy_ms']:.3f} ms (idle share {tr['idle_share']:.3f} of "
            f"an untraced step's {step_ms:.2f} ms; {tr['device_events']} "
            f"device events); backward kernels {tr['bwd_ms']} "
            f"({tr['bwd_share']:.4f} of busy), K4 forward "
            f"{tr['k4_ms']:.3f} ms ({tr['k4_share']:.4f}); most device "
            "time: " + "; ".join(f"{n} {t:.3f} ms"
                                 for n, t in tr["top_kernels_ms"]))
    else:
        log("[train] (c) traced embedder step: no device activity recorded "
            "(not measured)")
    check(d1 - n1 > 0 and d1 - n1 > d0 - n0,
          f"[train] (c) the embedder's gap did not widen: {emb}")
    check(f32 >= EMBED_TRAIN_STEPS * per_step
          and one >= EMBED_TRAIN_STEPS * per_step,
          f"[train] (c) f32 K4 launches {f32}, one-pass backward launches "
          f"{one} in {EMBED_TRAIN_STEPS} steps")
    return {"lm_losses": losses, "reduced": reduced, "embedder": emb,
            "lm_s": lm_s,
            "embedder_s": emb_s, "embedder_host_ms": host_ms,
            "embedder_step_ms": step_ms, "embedder_trace": tr}


def phase_train(torch, np, seed: int) -> dict:
    """Phase 13: the backward kernels against their plain versions (a),
    qwen3-14b, minicpm3-4b, paligemma-3b and rwkv6-7b training at full
    width (b) and the trainers (c). The forward's and backward's launches
    on the main path are counted from (b) to the end of (c): every f32
    call there (the embedder's) takes the one-pass kernel, so the tiled
    f32 pair has none, and no call takes the wide pair's <192, 128>
    instance (deepseek-v2's widths, held in (a) only)."""
    t0 = time.perf_counter()
    kern = train_kernels(torch, seed)
    walls = {"a": time.perf_counter() - t0}
    zero_attention_launches()
    zero_train_counts()
    runs = {}
    for arch in (TRAIN_ARCH,) + TRAIN_KINDS:
        t = time.perf_counter()
        runs[arch] = train_full(torch, np, arch, seed)
        walls[arch] = time.perf_counter() - t
    t = time.perf_counter()
    launchers = train_launchers(torch, np)
    walls["c"] = time.perf_counter() - t
    launches = attention_launches()
    launches.update(train_counts())
    check(launches["flash_attention_bwd_f32"]
          == launches["flash_attention_bwd_f32_one_pass"],
          f"[train] an f32 backward call of the main path took the tiled "
          f"pair: {launches}")
    check(launches["plain_attention_bwd"] == 0,
          f"[train] the plain attention backward ran on the main path: "
          f"{launches}")
    wall = time.perf_counter() - t0
    log(f"[train] phase done in {wall:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + f"); launches "
        f"{launches}")
    return {"kernels": kern, "qwen3": runs[TRAIN_ARCH], "walls": walls,
            "kinds": {a: runs[a] for a in TRAIN_KINDS},
            "launchers": launchers, "launches": launches, "wall_s": wall}


def mask_pairs(L: int, causal: bool, prefix_len: int = 0) -> int:
    """The (query, key) pairs a square mask lets through: all, or the
    causal half with the first ``prefix_len`` keys seen by every row."""
    if not causal:
        return L * L
    p = min(prefix_len, L)
    return L * (L + 1) // 2 + p * (p - 1) // 2


def plain_bwd(torch, q, k, v, o, do, **kw):
    """``attention_bwd_ref`` on the call's inputs; where its f32 score
    tensors would pass 2^30 elements (deepseek-v2's 128 heads at 4,096
    tokens), a block of kv heads at a time, 2^29 elements each: the same
    function on the same inputs, its tensors cut to fit the card."""
    from repro_torch.kernels.flash_attention import ref as fr
    B, Lq, H, _ = q.shape
    Lkv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if B * H * Lq * Lkv <= 2 ** 30:
        return fr.attention_bwd_ref(q, k, v, o, do, **kw)
    step = max(1, min(Hkv, 2 ** 29 // (B * G * Lq * Lkv)))
    out = [fr.attention_bwd_ref(q[:, :, h * G:(h + step) * G],
                                k[:, :, h:h + step], v[:, :, h:h + step],
                                o[:, :, h * G:(h + step) * G],
                                do[:, :, h * G:(h + step) * G], **kw)
           for h in range(0, Hkv, step)]
    return tuple(torch.cat(x, dim=2) for x in zip(*out))


def sdpa_bwd_call(torch, q, k, v, do, **kw):
    """SDPA's backward (autograd of scaled_dot_product_attention, with
    enable_gqa; the mask as is_causal, or as a boolean mask where a prefix
    is set) on the call's inputs, a yardstick the port never calls; None
    where SDPA does not take the call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref as fr
    H, Hkv = q.shape[2], k.shape[2]
    causal, prefix = kw.get("causal", True), kw.get("prefix_len", 0)
    mask = None
    if prefix:
        mask = fr.attention_mask(q.shape[1], k.shape[1], causal=causal,
                                 window=None, prefix_len=prefix, q_offset=0,
                                 kv_valid_len=None, device=q.device)[0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=H != Hkv)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
        lib()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"[timing] SDPA does not take {tuple(q.shape)} x "
            f"{tuple(v.shape)} {kw}: {str(e).splitlines()[0][:120]}")
        return None
    return lib


def bwd_timing(torch, seed: int) -> dict:
    """The backward's kernels, each beside the plain backward, SDPA's
    backward (``sdpa_bwd_call``; None where SDPA does not take the call)
    and its bound, with its device ms from a profiled
    ``flash_attention_bwd`` call, which must launch the route's kernels and
    nothing else: the tiled pair at qwen3-14b's 4,096-token causal prefill
    (BWD_TIMED, bf16) and at phase 13 (a)'s 1,024-token f32 call (the f32
    instances), the wgmma pair at minicpm3-4b's (96, 64) (BWD_MLA), the
    wide bf16 pair at paligemma-3b's 256 with its prefix at phase 13 (b)'s
    4,352 tokens (BWD_PALIGEMMA; (b) must take the SPLIT instance that the
    library picks for that grid, as the step's call does) and at
    deepseek-v2's (192, 128) (BWD_DEEPSEEK; its plain backward by
    ``plain_bwd``'s head blocks), each kernel by CUDA events, (a) then (b)
    on the same buffers; and the one-pass kernel at the embedder's call
    (BWD_EMBED, f32, bidirectional), by CUDA events around one launch. The
    bound of each pair kernel counts the products
    its outputs need in a standard backward, over the pairs the mask lets
    through: (a) S (over Dq), dP (over Dv) and dQ (Dq), (b) S, dP, dV
    (Dv) and dK (Dq) (the extra Q K^T pass of (a) is not credited), at
    the peak of the inputs' type, against the bytes of its inputs read and
    outputs written once; the one-pass kernel's is the whole backward's:
    the five products against q, k, v, o, do read and dq, dk, dv written
    once. A profiled call that records no kernel fails."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops as fa
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    out = {}
    for label, shape, dtype, kw in (
            ("prefill", BWD_TIMED, torch.bfloat16, dict(causal=True)),
            ("tiled_f32", dict(BWD_TIMED, Lq=1024, Lkv=1024), torch.float32,
             dict(causal=True)),
            ("embedder", BWD_EMBED, torch.float32, dict(causal=False)),
            ("dv", BWD_MLA, torch.bfloat16, dict(causal=True)),
            ("wide", BWD_PALIGEMMA, torch.bfloat16, BWD_PALIGEMMA_MASK),
            ("wide192", BWD_DEEPSEEK, torch.bfloat16, dict(causal=True))):
        B, L, H, Hkv, Dq = (shape[x] for x in ("B", "Lq", "H", "Hkv", "Dh"))
        Dv = shape.get("Dv", Dq)
        route = fa.bwd_route(dtype, L, L, Dq, Dv)
        q, k, v, o, do = bwd_inputs(torch, shape, dtype, seed + 39, **kw)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        lse, dsum = (None, None) if route == "one_pass" else \
            K.bwd_scratch(q)
        saved = None
        if fa.saves_lse(dtype, Dq, Dv):
            # the training path's call: (a) from K4's saved LSE
            saved = fa._forward(q, k, v, kw["causal"], None,
                                kw.get("prefix_len", 0), 0, None,
                                with_lse=True)[1]
            lse = saved
        esz = q.element_size()
        pairs = mask_pairs(L, kw["causal"], kw.get("prefix_len", 0))
        pq, pv = 2.0 * B * H * Dq * pairs, 2.0 * B * H * Dv * pairs
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else \
            H100_FP32_FLOPS
        qb, ob = esz * B * L * H * Dq, esz * B * L * H * Dv
        kb, vb = esz * B * L * Hkv * Dq, esz * B * L * Hkv * Dv
        stats = 2 * 4 * B * H * L
        whole = att_bound(2 * (qb + ob + kb + vb), 3 * pq + 2 * pv, peak)
        bounds = {"dq": att_bound(2 * qb + 2 * ob + kb + vb + stats,
                                  2 * pq + pv, peak),
                  "dkv": att_bound(qb + ob + 2 * (kb + vb) + stats,
                                   2 * pq + 2 * pv, peak),
                  "one_pass": whole}
        plain_ms = cuda_ms(torch, lambda: plain_bwd(torch, q, k, v, o, do,
                                                    **kw), iters=3, warmup=1)
        lib = sdpa_bwd_call(torch, q, k, v, do, **kw)
        lib_ms = None if lib is None else cuda_ms(torch, lib)
        lib_dev = {"library_device_ms": None} if lib is None else \
            library_device_ms(torch, lib)
        own, records = device_kernel_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, do, lse=saved, **kw), iters=10)
        names = sorted(n.split("(")[0].split("<")[0].replace("void ", "")
                       for n in own)
        parts = (("one_pass", 2),) if route == "one_pass" else \
            (("dq", 0 if saved is None else 3), ("dkv", 1))
        kind = "wide_bf16" if route == "tiled_wide" else _kind(dtype)
        want = [f"fab::bwd_{name}_{kind}" for name, _ in parts]
        if saved is not None:
            want[0] = "fab::bwd_dq_lse_bf16"
        check(names == sorted(want),
              f"[timing] flash_attention_bwd {label}: one call launches "
              f"{list(own)}, not the {route} route's kernels alone")
        if route == "tiled_wide" and max(Dq, Dv) > 192:
            # (b) at <256, 256> has an instance a SPLIT: the one the
            # library picks for this grid, which the main path's call of
            # this shape takes too
            split = bwd_lib_fn("flash_attention_bwd_split")(B, Hkv, L)
            want = f"fab::bwd_dkv_wide_bf16<256, 256, {split}>"
            check(any(want in n for n in own),
                  f"[timing] flash_attention_bwd {label}: one call launches "
                  f"{list(own)}, not {want}")
        for name, part in parts:
            call = (lambda part=part: K.launch_bwd(
                q, k, v, o, do, dq, dk, dv, lse, dsum, causal=kw["causal"],
                window=0, prefix_len=kw.get("prefix_len", 0), q_offset=0,
                part=part))
            dev = [t for n, t in own.items() if f"bwd_{name}_" in n]
            b_ms, b_by = bounds[name]
            rec = {"shape": shape, "dtype": _dtype_name(dtype), **kw,
                   "route": route, "saved_lse": saved is not None,
                   "instance": [n.split("(")[0].replace("void ", "")
                                for n in own if f"bwd_{name}_" in n][0],
                   "ms": cuda_ms(torch, call, iters=20),
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ms": dev[0],
                   "library_device_ms": lib_dev["library_device_ms"],
                   "whole_bound_ms": whole[0],
                   "device_records": list(records.values())}
            key = {"prefill": f"flash_attention_bwd_{name}",
                   "tiled_f32": f"flash_attention_bwd_{name}_f32",
                   "embedder": "flash_attention_bwd_f32"}.get(
                label, f"flash_attention_bwd_{name}_{label}")
            out[key] = rec
            what = {"dq": "(a) dq", "dkv": "(b) dkv",
                    "one_pass": "one-pass"}[name]
            lib_txt = "none" if lib_ms is None else (
                f"{lib_ms:.4f} ms ({rec['library_device_ms']} ms on the "
                f"device)")
            log(f"[timing] flash_attention_bwd {what} {label} {shape} "
                f"{_dtype_name(dtype)} {kw} ({route}): {rec['instance']} "
                f"{rec['ms']:.4f} ms (CUDA events), {rec['device_ms']:.4f} ms "
                f"on the device ({b_ms / rec['device_ms']:.3f} of its bound)"
                f", plain backward {plain_ms:.4f} ms, SDPA's backward "
                f"{lib_txt}, bound {b_ms:.4f} ms ({b_by}; the whole "
                f"backward's {whole[0]:.4f} ms, {whole[1]})")
        if label == "tiled_f32":
            f32_parent_turns(torch, (q, k, v, o, do), kw, out)
        del q, k, v, o, do, dq, dk, dv, lib, saved, lse, dsum
        gc.collect()
        torch.cuda.empty_cache()
    out["wkv6_bwd"], out["wkv6_ckpt"] = wkv6_bwd_timing(torch, seed)
    return out


BWD_F32_ROUNDS = 4      # rounds of the f32 pair against its parent


def f32_parent_turns(torch, xs, kw: dict, out: dict) -> None:
    """The f32 tiled pair's (a) and (b) at ``xs`` beside the pair before
    its Hopper redesign (``tools/attention_bwd_f32_parent.cu``, built here
    from the checkout), each launched alone under torch.profiler (device ms
    a call, the mean of 10), in BWD_F32_ROUNDS rounds of alternating order
    (the port's, the parent's; then the reverse), each pair on its own
    scratch. Adds ``parent_device_ms`` (the median) and ``turns`` (every
    reading) to the ``flash_attention_bwd_{dq,dkv}_f32`` records; fails if
    a launch records a kernel other than the one asked for."""
    import statistics
    from repro_torch.kernels.flash_attention import kernel as K
    sys.path.insert(0, str(ROOT))
    from tools.bwd_variants import launch_parent_f32, parent_f32_entry
    from tools.trace_kernels import device_kernel_ms
    parent, _ = parent_f32_entry()
    q = xs[0]
    args = dict(causal=kw["causal"], window=0,
                prefix_len=kw.get("prefix_len", 0), q_offset=0)
    fns = {"port": K.launch_bwd,
           "parent": lambda *a, **k: launch_parent_f32(torch, parent, *a,
                                                       **k)}
    runs = {}
    for who, fn in fns.items():
        grads = [torch.empty_like(x) for x in xs[:3]]
        scratch = K.bwd_scratch(q)
        runs[who] = [lambda fn=fn, part=part, g=grads, s=scratch: fn(
            *xs, *g, *s, part=part, **args) for part in (0, 1)]
        for call in runs[who]:
            call()
    got = {(who, name): [] for who in runs for name in ("dq", "dkv")}
    for r in range(BWD_F32_ROUNDS):
        for who in (("port", "parent") if r % 2 == 0 else ("parent", "port")):
            for part, name in enumerate(("dq", "dkv")):
                own = device_kernel_ms(torch, runs[who][part], iters=10)[0]
                want = ("fab_parent::" if who == "parent" else "fab::") + \
                    f"bwd_{name}_f32<"
                check(len(own) == 1 and want in next(iter(own)),
                      f"[timing] {who}'s f32 {name}: one launch records "
                      f"{list(own)}")
                got[(who, name)].append(sum(own.values()))
    for name in ("dq", "dkv"):
        rec = out[f"flash_attention_bwd_{name}_f32"]
        rec["parent_device_ms"] = statistics.median(got[("parent", name)])
        rec["turns"] = {who: got[(who, name)] for who in runs}
        port = statistics.median(got[("port", name)])
        log(f"[timing] flash_attention_bwd {name} f32 in turns with the "
            f"pair before its Hopper redesign ({BWD_F32_ROUNDS} rounds, "
            f"medians): {port:.4f} ms on the device against "
            f"{rec['parent_device_ms']:.4f} ms "
            f"({rec['parent_device_ms'] / port:.2f}x); readings "
            f"{rec['turns']}")


def wkv6_bwd_timing(torch, seed: int) -> tuple[dict, dict]:
    """K5-bwd and the checkpointing K5 at rwkv6-7b's training shape
    (WKV6_BWD_TIMED, bf16 r/k/v, a zero state, the cotangent of y alone).
    K5-bwd alone from saved checkpoints (CUDA events and torch.profiler),
    its plain reverse loop, and the bound: the fp32 flops the function
    needs a (token, head), 14 K V (the state P_t once more, 3 K V; per
    entry FMAs for dr, dk, dw and dv, and a product and an FMA for G),
    against r, k, v, dr, dk, dv (bf16), w, dy, dw (f32), u, du and the
    state and its cotangent (f32) moved once. K5 with checkpoint writes
    (``wkv6_ckpt``) at the same shape beside K5 without them, its plain
    version (``wkv6_ref`` and ``wkv6_ckpt_ref``) and its bound (K5's, with
    the checkpoints' bytes written). Then the device ms of K5-bwd, of its
    first design (``tools/wkv6_bwd_probe.py``'s ``three_sweeps``, on no
    path) and of K5 with and without checkpoint writes, in WKV6_BWD_ROUNDS
    rounds of alternating order (first design, K5-bwd, K5, K5 with
    checkpoints; then the reverse): medians and readings. No single
    PyTorch call computes either function: library_ms is None."""
    import statistics
    from repro_torch.kernels.wkv6 import kernel as K5, ops, ref
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import device_kernel_ms
    from tools.wkv6_bwd_probe import three_sweeps
    B, L, H, K = (WKV6_BWD_TIMED[x] for x in "BLHK")
    xs, dy, _ = wkv6_bwd_inputs(torch, B, L, H, K, torch.bfloat16, False,
                                seed + 37)
    r, k, v, w, u, s = xs
    uf = u.float().contiguous()
    y, s_out = torch.empty((B, L, H, K), device=DEV), torch.empty_like(s)
    ck = K5.ckpt_buffer(r)
    calls = {"three_sweeps": lambda: three_sweeps(torch, *xs, dy),
             "wkv6_bwd": lambda: ops.wkv6_bwd(*xs, dy, ckpt=ck),
             "wkv6": lambda: K5.launch(r, k, v, w, uf, s, y, s_out),
             "wkv6_ckpt": lambda: K5.launch(r, k, v, w, uf, s, y, s_out,
                                            ck)}
    calls["wkv6_ckpt"]()
    flops = 14.0 * B * L * H * K * K
    nbytes = (6 * 2 + 3 * 4) * B * L * H * K + 2 * 4 * H * K \
        + 2 * 4 * B * H * K * K
    b_ms, b_by = att_bound(nbytes, flops, H100_FP32_FLOPS)
    rec = {"shape": WKV6_BWD_TIMED, "dtype": "bfloat16",
           "ms": cuda_ms(torch, calls["wkv6_bwd"]),
           "plain_ms": cuda_ms(torch, lambda: ref.wkv6_bwd_ref(*xs, dy),
                               iters=1, warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    fflops = B * L * H * (5.0 * K * K + 3 * K + 2 * K)
    fbytes = (3 * 2 + 4 + 4) * B * L * H * K + 2 * H * K \
        + 2 * 4 * B * H * K * K + 4 * ck.numel()
    fb_ms, fb_by = att_bound(fbytes, fflops, H100_FP32_FLOPS)
    crec = {"shape": WKV6_BWD_TIMED, "dtype": "bfloat16",
            "ms": cuda_ms(torch, calls["wkv6_ckpt"]),
            "no_ckpt_ms": cuda_ms(torch, calls["wkv6"]),
            "plain_ms": cuda_ms(torch, lambda: (
                ref.wkv6_ref(*xs), ref.wkv6_ckpt_ref(k, v, w, s)),
                iters=1, warmup=1),
            "library_ms": None, "bound_ms": fb_ms, "bound_by": fb_by}
    keys = {"three_sweeps": "wkv6_bwd", "wkv6_bwd": "wkv6_bwd",
            "wkv6": "wkv6_fwd<", "wkv6_ckpt": "wkv6_fwd_ckpt"}
    got = {n: [] for n in calls}
    order = list(calls)
    for i in range(WKV6_BWD_ROUNDS):
        for name in (order if i % 2 == 0 else order[::-1]):
            own, _ = device_kernel_ms(torch, calls[name], iters=10)
            kern = [t for n, t in own.items() if keys[name] in n]
            check(len(kern) == 1, f"[timing] {name}: one call launches "
                                  f"{list(own)}")
            got[name].append(kern[0])
    med = {n: statistics.median(t) for n, t in got.items()}
    rec.update(device_ms=med["wkv6_bwd"],
               parent_device_ms=med["three_sweeps"], readings=got)
    crec.update(device_ms=med["wkv6_ckpt"], no_ckpt_device_ms=med["wkv6"])
    del xs, dy, y, s_out, ck
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[timing] wkv6_bwd {WKV6_BWD_TIMED} bf16: kernel {rec['ms']:.4f} ms "
        f"(CUDA events), {rec['device_ms']:.4f} ms on the device "
        f"({b_ms / rec['device_ms']:.3f} of the bound; median of "
        f"{WKV6_BWD_ROUNDS} readings), the first design "
        f"{rec['parent_device_ms']:.4f} ms ({rec['parent_device_ms'] / rec['device_ms']:.2f}x), "
        f"plain {rec['plain_ms']:.2f} ms, library none, bound "
        f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); readings {got}")
    log(f"[timing] wkv6_ckpt {WKV6_BWD_TIMED} bf16: kernel {crec['ms']:.4f} "
        f"ms (CUDA events; without checkpoint writes "
        f"{crec['no_ckpt_ms']:.4f}), {crec['device_ms']:.4f} ms on the "
        f"device (without {crec['no_ckpt_device_ms']:.4f}: "
        f"{crec['device_ms'] - crec['no_ckpt_device_ms']:+.4f} ms for "
        f"{4 * K * K * B * H * -(-L // 16) / 1e6:.1f} MB of checkpoints; "
        f"{fb_ms / crec['device_ms']:.3f} of the bound), plain "
        f"{crec['plain_ms']:.2f} ms, library none, bound {fb_ms:.4f} ms "
        f"({fb_by}; {fbytes / 1e6:.1f} MB)")
    return rec, crec


# the consumer warpgroups' registers after setmaxnreg in the bf16 backward
# kernels (csrc/flash_attention_bwd.cu; the producer's drop to 24), which
# ptxas does not report; their dynamic shared memory comes from the
# library itself (``bwd_bf16_smem``)
BWD_CONSUMER_REGS = 240


def bwd_lib_fn(name: str):
    """C function ``name`` of the built backward library, of three int64
    arguments and an int result, which launches nothing."""
    import ctypes
    from repro_torch.kernels import _build
    fn = getattr(ctypes.CDLL(str(_build._lib_path("flash_attention_bwd"))),
                 name)
    fn.argtypes = [ctypes.c_longlong] * 3
    fn.restype = ctypes.c_int
    return fn


def bwd_bf16_smem(kernel: str, dq: int, dv: int) -> int:
    """The dynamic shared memory that the built library launches bf16
    backward kernel ``kernel`` at widths <dq, dv> with (its C function
    ``flash_attention_bwd_smem``, from the sizes the launch uses)."""
    part = 3 if kernel == "bwd_dq_lse_bf16" else \
        0 if kernel.startswith("bwd_dq_") else 1
    smem = bwd_lib_fn("flash_attention_bwd_smem")(dq, dv, part)
    check(smem > 0, f"[build] flash_attention_bwd_smem({dq}, {dv}) of "
                    f"{kernel}: {smem}")
    return smem


# the bf16 instances the C dispatch has: the wgmma pair at every (DQP,
# DVP) of 64 and 128, without and with kv_valid_len (<..., RAGGED>), the
# exact-width pair at <96, 64> ((a) from a saved LSE, bwd_dq_lse_bf16, and
# (b)), the wide pair at <192, 128> and <256, 256> (its (b) with dK's and
# dV's columns whole or split across two CTAs, <..., SPLIT>)
BWD_BF16_INSTANCES = tuple(
    f"{k}<{dq}, {dv}, {r}>" for k in ("bwd_dq_bf16", "bwd_dkv_bf16")
    for dq in (64, 128) for dv in (64, 128) for r in ("false", "true")
) + tuple(
    f"{k}<96, 64, {r}>" for k in ("bwd_dq_lse_bf16", "bwd_dkv_bf16")
    for r in ("false", "true")
) + tuple(
    f"bwd_dq_wide_bf16<{dq}, {dv}>" for dq, dv in ((192, 128), (256, 256))
) + tuple(f"bwd_dkv_wide_bf16<{dq}, {dv}, {n}>"
          for dq, dv, n in ((192, 128, 1), (256, 256, 1), (256, 256, 2)))


def bwd_bf16_ptxas(report) -> dict:
    """Registers, shared memory and spills of each bf16 backward kernel
    instance (BWD_BF16_INSTANCES) from the ptxas report of its library's
    build, and the HGMMA instructions of its SASS (``cuobjdump -sass``),
    logged; fails if one spills, if ptxas serialised a wgmma instance's
    products (a warning that names the function: about a fifth of dQ's
    time when it happened), if one runs no HGMMA, or if one is missing
    from a report (a build of this run)."""
    import re
    from repro_torch.kernels import _build
    if report is None:
        log("[build] flash_attention_bwd was built before this run: no "
            "ptxas report to read")
        return {}
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import ptxas_functions, sass_mix

    def instance(fn):
        m = re.match(r"_ZN3fab\d+(bwd_(?:dq|dkv)_(?:wide_|lse_)?bf16)"
                     r"ILi(\d+)ELi(\d+)E(?:Li(\d+)E|Lb(\d)E)?", fn)
        if m is None:
            return None
        last = "" if m.group(4) is None else f", {m.group(4)}"
        if m.group(5) is not None:
            last = ", true" if m.group(5) == "1" else ", false"
        return (f"{m.group(1)}<{m.group(2)}, {m.group(3)}{last}>",
                m.group(1), int(m.group(2)), int(m.group(3)))
    out = {}
    for fn, r in ptxas_functions(report).items():
        m = instance(fn)
        if m:
            out.setdefault(m[0], {"kernel": m[1], "dq": m[2],
                                  "dv": m[3]}).update(r)
    for fn, c in sass_mix(str(_build._lib_path("flash_attention_bwd")),
                          "bf16").items():
        m = instance(fn)
        if m and m[0] in out:
            out[m[0]]["hgmma"] = c["function"]["HGMMA"]
    check(sorted(out) == sorted(BWD_BF16_INSTANCES),
          f"[build] the ptxas report names {sorted(out)}, not the bf16 "
          f"backward kernels {sorted(BWD_BF16_INSTANCES)}")
    for name, r in sorted(out.items()):
        r["dynamic_smem"] = bwd_bf16_smem(r["kernel"], r["dq"], r["dv"])
        r["consumer_registers"] = BWD_CONSUMER_REGS
        log(f"[build] fab::{name}: {r.get('registers')} registers a thread "
            f"at launch ({BWD_CONSUMER_REGS} in the consumer warpgroups by "
            f"setmaxnreg), {r.get('static_smem')} B static + "
            f"{r['dynamic_smem']:,} B "
            f"dynamic shared memory, {r.get('spill_stores')} B spill stores, "
            f"{r.get('spill_loads')} B spill loads, {r.get('stack')} B "
            f"stack, {r.get('hgmma')} HGMMA in its SASS")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"[build] fab::{name} spills: {r}")
        check("wgmma_serialized" not in r,
              f"[build] fab::{name}: {r.get('wgmma_serialized')}")
        check(r.get("hgmma", 0) > 0, f"[build] fab::{name}: no HGMMA in its "
                                     f"SASS: {r}")
    return out


def wkv6_bwd_ptxas(report) -> dict:
    """Registers and spills of K5-bwd's instances (``wkv6_bwd_chunks``, 32
    state columns a CTA, in f32 and bf16) from the ptxas report of its
    library's build, logged; fails if one spills or is missing from a
    report of this run."""
    import re
    if report is None:
        log("[build] wkv6_bwd was built before this run: no ptxas report to "
            "read")
        return {}
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import ptxas_functions
    out = {}
    for fn, r in ptxas_functions(report).items():
        m = re.match(r"_ZN4wkvb\d+(wkv6_bwd_\w+?)I(f|13__nv_bfloat16)E", fn)
        if m:
            out[f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}>"] \
                = r
    check(len(out) == 2, f"[build] the ptxas report names {sorted(out)}, "
                         f"not K5-bwd's two instances")
    for name, r in sorted(out.items()):
        log(f"[build] wkvb::{name}: {r.get('registers')} registers a thread, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} "
            f"B spill loads, {r.get('stack')} B stack")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"[build] wkvb::{name} spills: {r}")
    return out


def bwd_one_pass_ptxas(report) -> dict:
    """Registers and spills of each instance of the f32 one-pass backward
    kernel (``bwd_one_pass_f32<T, DP, VEC, GQA>``) from the ptxas report of
    its library's build, logged; fails if one spills (the embedder's
    instance, T 32 and DP 64 with one query head a kv head, is capped at 96
    registers for five CTAs an SM) or if that instance is missing from a
    report of this run."""
    import re
    if report is None:
        return {}
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import ptxas_functions
    out = {}
    for fn, r in ptxas_functions(report).items():
        m = re.match(r"_ZN3fab\d+bwd_one_pass_f32ILi(\d+)ELi(\d+)ELb(\d)"
                     r"ELb(\d)E", fn)
        if m:
            out.setdefault("bwd_one_pass_f32<{}, {}, {}, {}>".format(
                m.group(1), m.group(2), *("true" if x == "1" else "false"
                                          for x in m.group(3, 4))),
                {}).update(r)
    for name, r in sorted(out.items()):
        log(f"[build] fab::{name}: {r.get('registers')} registers a thread, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} "
            f"B spill loads, {r.get('stack')} B stack")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"[build] fab::{name} spills: {r}")
    check("bwd_one_pass_f32<32, 64, true, false>" in out,
          f"[build] the ptxas report names {sorted(out)}, not the "
          f"embedder's one-pass instance")
    return out


# the f32 tiled pair's instances: (a) and (b) at DP 64, 128 and 256, with
# 16-byte copies (VEC) and without
BWD_TILED_F32_INSTANCES = tuple(
    f"{k}<{dp}, {vec}>" for k in ("bwd_dq_f32", "bwd_dkv_f32")
    for dp in (64, 128, 256) for vec in ("false", "true"))


def bwd_tiled_f32_ptxas(report) -> dict:
    """Registers and spills of each instance of the f32 tiled pair
    (BWD_TILED_F32_INSTANCES) from the ptxas report of its library's build,
    and the FFMA and tensor-core (HMMA, HGMMA) instructions of its SASS
    (``cuobjdump -sass``), logged; fails if one spills, if one runs a
    tensor-core instruction (the pair's contract is fp32 FFMAs alone), or
    if one is missing from a report of this run."""
    import re
    from repro_torch.kernels import _build
    if report is None:
        return {}
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import ptxas_functions, sass_mix

    def instance(fn):
        m = re.match(r"_ZN3fab\d+(bwd_(?:dq|dkv)_f32)ILi(\d+)ELb(\d)E", fn)
        return None if m is None else "{}<{}, {}>".format(
            m.group(1), m.group(2), "true" if m.group(3) == "1" else "false")
    out = {}
    for fn, r in ptxas_functions(report).items():
        if instance(fn):
            out.setdefault(instance(fn), {}).update(r)
    for fn, c in sass_mix(str(_build._lib_path("flash_attention_bwd")),
                          "_f32").items():
        if instance(fn) in out:
            out[instance(fn)].update(
                {x: c["function"][x] for x in ("FFMA", "HMMA", "HGMMA")})
    check(sorted(out) == sorted(BWD_TILED_F32_INSTANCES),
          f"[build] the ptxas report names {sorted(out)}, not the f32 tiled "
          f"pair's {sorted(BWD_TILED_F32_INSTANCES)}")
    for name, r in sorted(out.items()):
        log(f"[build] fab::{name}: {r.get('registers')} registers a thread, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} "
            f"B spill loads, {r.get('stack')} B stack; SASS FFMA "
            f"{r.get('FFMA')}, HMMA {r.get('HMMA')}, HGMMA {r.get('HGMMA')}")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"[build] fab::{name} spills: {r}")
        check(r.get("FFMA", 0) > 0 and r.get("HMMA") == 0
              and r.get("HGMMA") == 0,
              f"[build] fab::{name}: tensor-core instructions in its SASS, "
              f"or no FFMA: {r}")
    return out


def fwd_bf16_smem(kernel: str, dq: int, dv: int, bk: int) -> int:
    """Dynamic shared memory of a bf16 K4 instance (flash_attention.cu's
    Layout and PCfg): 64-column slabs of 128-byte rows; flash_bf16 one Q
    tile and a two-stage K/V ring, flash_bf16_persistent two Q tiles and
    as many stages (2 or 3) as 227 KB holds."""
    sq, sv = -(-dq // 64), -(-dv // 64)
    q, kv = 2 * sq * 64 * 128, bk * (sq + sv) * 128
    if kernel == "flash_bf16":
        return 1024 + q + 2 * kv
    stages = 3 if (232448 - 1536 - 2 * q) // kv >= 3 else 2
    return 1024 + 2 * q + stages * kv


def fwd_bf16_ptxas(report) -> dict:
    """Registers, shared memory and spills of every bf16 K4 instance
    (``fa::flash_bf16<DQ, DV, BK>``,
    ``fa::flash_bf16_persistent<DQ, DV, BK>`` and the training forward's
    ``fa::flash_bf16_persistent_lse<96, 64, 192>``) from the ptxas report
    of its library's build, logged; fails if a flash_bf16_persistent
    instance (or its _lse twin) spills or ptxas serialised its wgmma, or
    if an instance that ``ops.fwd_route`` names, or the _lse one, is
    missing from a report of this run. The older flash_bf16 instances are
    logged only."""
    import re
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if report is None:
        log("[build] flash_attention was built before this run: no ptxas "
            "report to read")
        return {}
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import ptxas_functions
    out = {}
    for fn, r in ptxas_functions(report).items():
        m = re.match(r"_ZN2fa\d+(flash_bf16(?:_persistent(?:_lse)?)?)ILi"
                     r"(\d+)ELi(\d+)ELi(\d+)E", fn)
        if m:
            kernel, dq, dv, bk = m.group(1), *map(int, m.group(2, 3, 4))
            out.setdefault(f"{kernel}<{dq}, {dv}, {bk}>", {
                "kernel": kernel,
                "dynamic_smem": fwd_bf16_smem(kernel, dq, dv, bk)}).update(r)
    for name, r in sorted(out.items()):
        new = r["kernel"].startswith("flash_bf16_persistent")
        log(f"[build] fa::{name}: {r.get('registers')} registers a thread "
            f"at launch, {r.get('static_smem')} B static + "
            f"{r['dynamic_smem']:,} B dynamic shared memory, "
            f"{r.get('spill_stores')} B spill stores, "
            f"{r.get('spill_loads')} B spill loads, {r.get('stack')} B "
            f"stack, wgmma serialised: "
            f"{r.get('wgmma_serialized', 'no')}"
            + ("" if new else " (logged only)"))
        if new:
            check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                  f"[build] fa::{name} spills: {r}")
            check("wgmma_serialized" not in r,
                  f"[build] fa::{name}: {r.get('wgmma_serialized')}")
    routed = {fa_ops.fwd_route(torch.bfloat16, dq, dv)
              for dq, dv in PERSISTENT_PAIRS + ((64, 64), (128, 128),
                                                (256, 256))}
    # minicpm3's training forward: the instance that writes the LSE
    routed.add("flash_bf16_persistent_lse<96, 64, 192>")
    check(routed <= set(out), f"[build] the ptxas report names "
          f"{sorted(out)}, not every routed bf16 instance {sorted(routed)}")
    return out


def _kind(dtype) -> str:
    return "bf16" if "bfloat16" in str(dtype) else "f32"


# ---------------------------------------------------------------------------
# phase 14: the parallel training plane
# ---------------------------------------------------------------------------

# virtual (data, model) devices on the card: [cuda:0] * 4
PAR_MESH = (2, 2)
# (b): the global batch, one 1 x 2,048 row a data rank
PAR_BATCH = (2, 2048)
# (c): the ring's sum against the f32 sum of the ranks' gradients, of the
# largest |sum| (two ranks: one f32 add a chunk, exact); the int8
# all-reduce's relative error against the exact mean over the whole
# gradient (the reference's bound, tests/test_distributed.py:294); top-k's
# kept fraction
PAR_RING_RTOL = 1e-6
PAR_COMPRESS_RTOL = 0.05
PAR_TOPK_FRAC = 0.01
# (d): qwen3-14b's TRAIN_LAYERS blocks over as many virtual stages, four
# microbatches of 1 x 1,024; the block outputs within the kinds' logits
# limit (0.05 of the largest |value|) of the blocks run in order
PAR_PIPE = dict(stages=4, micro=4, B=4, L=1024)
PAR_PIPE_RTOL = 0.05
# (e): each MoE layer at full width on a virtual mesh: expert parallel
# where E % model == 0, else every expert's ffn sliced (mixtral's 14,336
# over 3: 4,779, 4,779, 4,778); B 2 x 2,048 tokens, one row a data shard;
# held against moe_apply(..., groups=2), the same per-shard capacity in
# one dispatch, to the bf16 limit of a sum of bf16 partials: 2^-7 (|plain|
# + the sum of the "model" shards' |partial outputs|) + PAR_MOE_ROW_RTOL x
# the row's rms of plain. Each partial rounds to bf16 before the sum (half
# an ulp, 2^-9 of it, in each of the two packages' roundings), and the
# sliced ffn's partials cancel, so an element's error scales with its
# partials, not with the output (par_moe_excess)
PAR_MOE = (("mixtral-8x7b", (2, 4)), ("mixtral-8x7b", (2, 3)),
           ("deepseek-v2-236b", (2, 4)))
PAR_MOE_TOKENS = (2, 2048)
PAR_MOE_ROW_RTOL = 2.0 ** -5
# (f): ElasticRunner over 4 virtual devices with the sharded step on the
# reduced qwen3-14b in f32 (the host holds the state between meshes); 2
# lost at step 3, a checkpoint every 2 steps, 6 steps of B 4 x 128
PAR_ELASTIC = dict(devices=4, lose=2, at=3, ckpt_every=2, steps=6, B=4,
                   L=128)


def par_bits(torch, x):
    """``x``'s bit pattern as integers of its width (exact comparisons)."""
    return x.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32}[x.element_size()])


def par_checksum(torch, x, chunk: int = 1 << 26) -> tuple:
    """Two integer sums of ``x``'s bit pattern (plain and position
    weighted), in chunks: equal checksums of two runs' moments stand for
    equal bits without holding both runs' 23 GB."""
    v = par_bits(torch, x).reshape(-1)
    s = w = 0
    for lo in range(0, v.numel(), chunk):
        c = v[lo:lo + chunk].to(torch.int64)
        idx = torch.arange(lo, lo + c.numel(), device=c.device) % 65521 + 1
        s += int(c.sum())
        w += int((c * idx).sum())
    return s, w


def par_leaf_rel(torch, a, b) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    top = float(b.float().abs().max())
    d = float((a.float() - b.float()).abs().max())
    return d / top if top else d


def par_moe_excess(torch, out, plain, abs_sum) -> float:
    """The largest |out - plain| over the limit of a sum of bf16 partials
    (PAR_MOE's comment): 2^-7 (|plain| + ``abs_sum``) + PAR_MOE_ROW_RTOL
    x the rms of plain's row. At most 1 passes."""
    out, plain = out.float(), plain.float()
    lim = 2.0 ** -7 * (plain.abs() + abs_sum) + PAR_MOE_ROW_RTOL \
        * plain.pow(2).mean(dim=-1, keepdim=True).sqrt()
    d = (out - plain).abs()
    ratio = torch.where(lim > 0, d / lim,
                        torch.where(d > 0, float("inf"), 0.0))
    return float(ratio.max())


def par_placements(torch, np, params, cfg, mesh) -> tuple:
    """(a): qwen3-14b at full width placed by ``param_specs(fsdp=True)``:
    every block has its spec's shape, the gather gives the same bits, and
    the virtual mesh holds one copy of the weights (no replica of a block
    on the one card); then the specs of every LM configuration on meta
    structs (rank, axes, divisibility at the production mesh's sizes for
    the MoE kinds, as tests/test_distributed.py:47)."""
    from repro_torch.configs.base import get_config, list_configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt
    t0 = time.perf_counter()
    specs = shd.param_specs(params, cfg, fsdp=True)
    placed = shd.place_tree(params, shd.named(mesh, specs))
    n_blocks = 0
    for (path, x), (_, p) in zip(opt.tree_leaves(params),
                                 opt.tree_leaves(placed)):
        for coord, key in p.keys():
            sl = shd.block_slices(x.shape, mesh, p.sharding.spec, coord)
            check(tuple(p.blocks[key].shape) == tuple(x[sl].shape),
                  f"[parallel] (a) {path} block at {coord}: "
                  f"{tuple(p.blocks[key].shape)}, spec {p.sharding.spec}")
        n_blocks += len(p.blocks)
        check(torch.equal(par_bits(torch, shd.gather(p)),
                          par_bits(torch, x)),
              f"[parallel] (a) {path}: the gather changed bits")
    placed_bytes = sum(p.nbytes() for _, p in opt.tree_leaves(placed))
    param_bytes = sum(x.numel() * x.element_size()
                      for _, x in opt.tree_leaves(params))
    check(placed_bytes == param_bytes,
          f"[parallel] (a) the virtual mesh holds {placed_bytes} bytes for "
          f"{param_bytes} bytes of weights")
    sizes = {"data": 16, "model": 16, "pod": 2}
    n_leaves = 0
    for arch in list_configs():
        acfg = get_config(arch)
        if acfg.family == "embedder":
            continue
        ps = steps.params_struct(acfg)
        for fsdp in (True, False):
            for (path, leaf), (_, spec) in zip(
                    opt.tree_leaves(ps),
                    opt.tree_leaves(shd.param_specs(ps, acfg, fsdp))):
                n_leaves += 1
                check(len(spec) == leaf.ndim and set(spec) <= {
                    None, "data", "model"}, f"[parallel] (a) {arch} "
                    f"{path}: spec {spec} for shape {tuple(leaf.shape)}")
                for dim, ax in enumerate(spec):
                    if ax is not None and acfg.is_moe and "mlp" in path:
                        check(leaf.shape[dim] % sizes[ax] == 0,
                              f"[parallel] (a) {arch} {path}: dim {dim} "
                              f"of {tuple(leaf.shape)} over {ax}")
    out = {"blocks": n_blocks, "placed_bytes": placed_bytes,
           "spec_leaves_checked": n_leaves,
           "wall_s": time.perf_counter() - t0}
    log(f"[parallel] (a) qwen3-14b x {TRAIN_LAYERS} layers on a "
        f"{PAR_MESH} virtual mesh: {n_blocks} blocks, every shape its "
        f"spec's, gathers bit-exact, {placed_bytes / 1e9:.2f} GB placed "
        f"for {param_bytes / 1e9:.2f} GB of weights; {n_leaves} specs of "
        f"the LM configurations checked ({out['wall_s']:.1f} s)")
    return placed, out


def par_pipeline(torch, np, cfg, params, seed: int) -> dict:
    """(d): qwen3-14b's blocks at full width split by ``stage_spans`` over
    PAR_PIPE stages on virtual devices, PAR_PIPE microbatches, against the
    blocks run in order on the whole batch; one microbatch sent past the
    next stage (a planted fault) must fail the limit."""
    import numpy as onp
    from repro_torch.distributed import pipeline
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L, lm
    t0 = time.perf_counter()
    S, M, B, Lq = (PAR_PIPE[k] for k in ("stages", "micro", "B", "L"))
    blocks = params["blocks"]
    rng = np.random.default_rng(seed + 1410)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, Lq))
                            .astype(onp.int32)).to(DEV)
    pos = torch.arange(Lq, device=DEV)

    def run(bps, h):
        for bp in bps:
            h = lm._block(bp, cfg, h, lambda a, bp=bp: L.gqa_attend(
                bp["attn"], cfg, a, pos, causal=True))
        return h
    spans = pipeline.stage_spans(len(blocks), S)
    mesh = Mesh(onp.array([torch.device(DEV, 0)] * S, dtype=object),
                ("stage",))
    stage_params = [blocks[a:b] for a, b in spans]
    with torch.no_grad():
        x = lm.embed_tokens(params, cfg, toks)
        want = run(blocks, x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = pipeline.pipeline_forward(run, stage_params, x, mesh=mesh,
                                        n_microbatches=M)
        torch.cuda.synchronize()
        pipe_ms = 1e3 * (time.perf_counter() - t)
        rel = par_leaf_rel(torch, got, want)
        real = pipeline._downstream
        pipeline._downstream = lambda s, mb: s + 2 if (s, mb) == (0, 0) \
            and S > 2 else s + 1
        try:
            bad = pipeline.pipeline_forward(run, stage_params, x, mesh=mesh,
                                            n_microbatches=M)
        finally:
            pipeline._downstream = real
        fault = par_leaf_rel(torch, bad, want)
    check(bool(torch.isfinite(got.float()).all()),
          "[parallel] (d) non-finite pipeline output")
    check(rel <= PAR_PIPE_RTOL, f"[parallel] (d) the pipeline's output "
                                f"differs by {rel:.4g} of the largest")
    check(fault > PAR_PIPE_RTOL, f"[parallel] (d) the limit passes a "
                                 f"microbatch sent to the wrong stage "
                                 f"({fault:.4g})")
    out = {"spans": spans, "rel": rel, "fault_rel": fault,
           "pipeline_ms": pipe_ms,
           "bubble": pipeline.bubble_fraction(S, M),
           "wall_s": time.perf_counter() - t0}
    log(f"[parallel] (d) qwen3-14b's {len(blocks)} blocks over {S} "
        f"virtual stages {spans}, {M} microbatches of 1 x {Lq}: "
        f"{rel:.4g} of the largest |output| from the blocks in order "
        f"(limit {PAR_PIPE_RTOL}); a microbatch sent past stage 1: "
        f"{fault:.4g}; {pipe_ms:.1f} ms on the host (GPipe bubble "
        f"{out['bubble']:.3f}; the stages share one card)")
    return out


def par_collectives(torch, np, sf, placed, batch) -> dict:
    """(c): the two data ranks' full-width gradients of (b)'s step, leaf
    by leaf: the ring all-reduce (the same bits on both ranks, within
    PAR_RING_RTOL of their f32 sum), the int8 all-reduce (relative error
    of the whole gradient against the exact mean), top-k with feedback at
    PAR_TOPK_FRAC (kept + residual == g + r exactly, the mean the kept
    parts' ring mean); one ring hop skipped (a planted fault) must fail
    the ring's check."""
    from repro_torch.distributed import collectives, compression
    from repro_torch.training import optimizer as opt
    t0 = time.perf_counter()
    grads = [[x for _, x in opt.tree_leaves(sf.rank_grads(placed, batch,
                                                          r)[1])]
             for r in range(2)]
    paths = [p for p, _ in opt.tree_leaves(placed)]
    ring_worst = 0.0
    err2 = ref2 = 0.0
    topk_kept = 0
    n = 0
    for i, path in enumerate(paths):
        xs = [grads[r][i].float() for r in range(2)]
        exact = xs[0] + xs[1]
        out = collectives.ring_allreduce_schedule(xs)
        check(torch.equal(par_bits(torch, out[0]), par_bits(torch, out[1])),
              f"[parallel] (c) {path}: the ranks' ring sums differ")
        ring_worst = max(ring_worst, par_leaf_rel(torch, out[0], exact))
        del out
        mean = compression.compressed_psum([{"g": grads[r][i]}
                                            for r in range(2)])
        check(torch.equal(par_bits(torch, mean[0]["g"]),
                          par_bits(torch, mean[1]["g"])),
              f"[parallel] (c) {path}: the ranks' int8 means differ")
        err2 += float(((mean[0]["g"].float() - exact / 2) ** 2).sum())
        ref2 += float(((exact / 2) ** 2).sum())
        del mean
        res0 = [torch.zeros_like(x) for x in xs]
        tmean, tres = compression.topk_psum_with_feedback(
            [{"g": grads[r][i]} for r in range(2)],
            [{"g": res0[r]} for r in range(2)], frac=PAR_TOPK_FRAC)
        kept = []
        for r in range(2):
            k_r, _ = compression.topk_sparsify(xs[r] + res0[r],
                                               PAR_TOPK_FRAC)
            check(torch.equal(k_r + tres[r]["g"], xs[r] + res0[r]),
                  f"[parallel] (c) {path}: kept + residual != g + r")
            kept.append(k_r)
            topk_kept += int((k_r != 0).sum())
        check(torch.equal(par_bits(torch, tmean[0]["g"]),
                          par_bits(torch, ((kept[0] + kept[1]) / 2)
                                   .to(tmean[0]["g"].dtype))),
              f"[parallel] (c) {path}: top-k's mean is not the kept parts'")
        n += 2 * xs[0].numel()
        del xs, exact, res0, tmean, tres, kept
    comp_rel = (err2 / ref2) ** 0.5
    # the planted fault: the first hop of one ring delivers nothing
    xs = [grads[r][0].float() for r in range(2)]
    exact = xs[0] + xs[1]
    real, hops = collectives._hop, []

    def skip_first(chunk, device):
        hops.append(1)
        return torch.zeros_like(chunk) if len(hops) == 1 else \
            real(chunk, device)
    collectives._hop = skip_first
    try:
        out = collectives.ring_allreduce_schedule(xs)
    finally:
        collectives._hop = real
    fault = max(par_leaf_rel(torch, o, exact) for o in out)
    del grads, xs, exact, out
    check(ring_worst <= PAR_RING_RTOL,
          f"[parallel] (c) the ring sum differs by {ring_worst:.3g}")
    check(fault > PAR_RING_RTOL,
          f"[parallel] (c) the ring's check passes a skipped hop "
          f"({fault:.3g})")
    check(comp_rel < PAR_COMPRESS_RTOL,
          f"[parallel] (c) int8 all-reduce relative error {comp_rel:.4g}")
    res = {"ring_worst_rel": ring_worst, "ring_fault_rel": fault,
           "int8_rel_err": comp_rel, "topk_kept_share": topk_kept / n,
           "wall_s": time.perf_counter() - t0}
    log(f"[parallel] (c) the two ranks' full-width gradients, "
        f"{len(paths)} leaves: ring sums the same bits on both ranks, "
        f"{ring_worst:.3g} of the largest from the f32 sum (limit "
        f"{PAR_RING_RTOL}; one hop skipped: {fault:.3g}); int8 all-reduce "
        f"relative error {comp_rel:.4g} of the exact mean (limit "
        f"{PAR_COMPRESS_RTOL}); top-k at {PAR_TOPK_FRAC}: kept + residual "
        f"== g + r exactly, {res['topk_kept_share']:.4f} of the entries "
        f"kept (ties kept); {res['wall_s']:.1f} s")
    return res


def par_step(torch, np, cfg, mesh, box: dict, placed, seed: int) -> dict:
    """(b): the sharded train step of qwen3-14b at full width on the
    virtual (2, 2) mesh, global batch PAR_BATCH, CE chunk 512, remat,
    AdamW: its loss, grad norm and mean gradient held against
    ``make_train_step``'s (``value_and_grad`` of the same loss) on one
    device at TRAIN_*_RTOL; then (c) on its ranks' gradients; then two
    steps from the same state, which must give the same bits (params
    compared whole, the moments by checksums), the second traced. K4 and
    the bf16 backward pair must launch in a step, twice a layer a rank (a
    pair a call), and the plain attention backward never. ``box["params"]``
    (the unplaced weights) is dropped once the one-device gradient is
    taken."""
    from repro_torch.distributed import sharded_train as st
    from repro_torch.launch import steps
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = box.pop("params")
    rng = np.random.default_rng(seed + 1401)
    batch = synth_batch(cfg, rng, *PAR_BATCH, DEV)
    loss1, g1 = steps.value_and_grad(lambda p: steps.chunked_ce_loss(
        p, cfg, batch, TRAIN_CE_CHUNK)[0], params)
    norm1 = float(opt.global_norm(g1))
    one_s = time.perf_counter() - t0
    optc = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=30)
    sf = st.make_sharded_train_step(cfg, mesh, optc=optc,
                                    ce_chunk=TRAIN_CE_CHUNK)
    bp = st.place_batch(batch, cfg, mesh)
    loss_s, mean, norm_s = sf.grads(placed, bp)
    worst, worst_leaf = 0.0, None
    for (path, a), (_, b) in zip(opt.tree_leaves(mean), opt.tree_leaves(g1)):
        r = par_leaf_rel(torch, a, b)
        if r > worst:
            worst, worst_leaf = r, "/".join(map(str, path))
    del mean, g1
    held = {"loss": float(loss_s), "loss_one_device": float(loss1),
            "grad_norm": float(norm_s), "grad_norm_one_device": norm1,
            "worst_leaf": worst_leaf, "worst_leaf_rel": worst}
    log(f"[parallel] (b) qwen3-14b x {TRAIN_LAYERS} layers, global batch "
        f"{PAR_BATCH[0]} x {PAR_BATCH[1]} on a {PAR_MESH} virtual mesh "
        f"(1 x {PAR_BATCH[1]} a data rank): loss {held['loss']:.5f} vs "
        f"{held['loss_one_device']:.5f} on one device, grad norm "
        f"{held['grad_norm']:.5f} vs {norm1:.5f}, largest leaf difference "
        f"{worst:.4g} of its largest |gradient| ({worst_leaf})")
    check(abs(held["loss"] - held["loss_one_device"])
          <= TRAIN_LOSS_RTOL * abs(held["loss_one_device"]),
          f"[parallel] (b) loss {held['loss']} vs one device "
          f"{held['loss_one_device']}")
    check(abs(held["grad_norm"] - norm1) <= TRAIN_GNORM_RTOL * norm1,
          f"[parallel] (b) grad norm {held['grad_norm']} vs {norm1}")
    check(worst <= TRAIN_GRAD_RTOL,
          f"[parallel] (b) gradient leaf {worst_leaf} differs by {worst:.4g}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    coll = par_collectives(torch, np, sf, placed, bp)
    gc.collect()
    torch.cuda.empty_cache()

    def moments_sums(state):
        return [par_checksum(torch, b) for t in (state.m, state.v)
                for _, x in opt.tree_leaves(t) for b in x.blocks.values()]

    runs = []
    for i in range(2):
        if i:
            p = lm.init_params(gen(torch, seed + 1400), cfg, DEV)
            placed = st.place_params(p, cfg, mesh)
            del p
        state = st.init_placed_state(placed)
        zero_attention_launches()
        zero_train_counts()
        out = {}

        def one():
            out["r"] = sf(placed, state, bp)
            out["loss"] = float(out["r"][2]["loss"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr = {}
        if i:
            tr = train_trace(torch, one)
        else:
            # the step's own peak, for the dry-run's prediction (phase 15)
            pre_peak = torch.cuda.max_memory_allocated()
            step_alloc0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t)
        counts = {**attention_launches(), **train_counts()}
        new_params, state, met = out["r"]
        runs.append({"host_ms": host_ms, "trace": tr, "launches": counts,
                     "metrics": {k: float(v) for k, v in met.items()},
                     "moments": moments_sums(state)})
        if i == 0:
            first = new_params
        else:
            for (path, a), (_, b) in zip(opt.tree_leaves(new_params),
                                         opt.tree_leaves(first)):
                for key, blk in a.blocks.items():
                    check(torch.equal(par_bits(torch, blk),
                                      par_bits(torch, b.blocks[key])),
                          f"[parallel] (b) {path}: the second step's "
                          f"params differ from the first's")
        del state
        gc.collect()
        torch.cuda.empty_cache()
    del first, placed, new_params
    a, b = runs
    check(a["metrics"] == b["metrics"] and a["moments"] == b["moments"],
          f"[parallel] (b) the step did not repeat: {a['metrics']} vs "
          f"{b['metrics']}, moments equal {a['moments'] == b['moments']}")
    peak = max(pre_peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    n = TRAIN_LAYERS * PAR_MESH[0]          # attention calls a step
    c = a["launches"]
    need = {"flash_attention": n, "flash_attention_bwd": 2 * n}
    check(all(c[k] >= v for k, v in need.items()),
          f"[parallel] (b) launches {c} in one step, short of {need}")
    check(c["plain_attention_bwd"] == 0,
          f"[parallel] (b) the plain attention backward ran "
          f"{c['plain_attention_bwd']} times")
    tr = b["trace"]
    if tr.get("busy_ms"):
        tr["idle_share"] = max(0.0, 1.0 - tr["busy_ms"] / a["host_ms"])
        log(f"[parallel] (b) traced step: wall "
            f"{tr['profiled_wall_ms']:.1f} ms, device busy "
            f"{tr['busy_ms']:.3f} ms (idle share {tr['idle_share']:.3f} of "
            f"the untraced step's {a['host_ms']:.1f} ms; "
            f"{tr['device_events']} device events); backward kernels "
            f"{tr['bwd_ms']} ({tr['bwd_share']:.4f} of busy), K4 forward "
            f"{tr['k4_ms']:.3f} ms ({tr['k4_share']:.4f}); most device "
            "time: " + "; ".join(f"{k} {t:.3f} ms"
                                 for k, t in tr["top_kernels_ms"]))
    else:
        log("[parallel] (b) traced step: no device activity recorded (not "
            "measured)")
    log(f"[parallel] (b) two steps from the same state: the same bits "
        f"(params whole, moments by checksum), loss {a['metrics']['loss']:.5f}"
        f", host ms {a['host_ms']:.1f} untraced, {b['host_ms']:.1f} traced; "
        f"peak memory {peak:.1f} GiB; launches in a step {c}; one-device "
        f"gradient {one_s:.1f} s")
    return {"held": held, "collectives": coll, "runs": runs,
            "peak_gib": peak, "step_peak_bytes": step_peak,
            "step_alloc_before_bytes": step_alloc0, "launches": c,
            "wall_s": time.perf_counter() - t0}


def par_moe(torch, np, seed: int) -> dict:
    """(e): ``moe_apply_shard_map`` on full-width MoE layers (PAR_MOE) over
    virtual meshes against ``moe_apply(..., groups=2)``, each within the
    bf16 limit of a sum of partials (``par_moe_excess``); one expert
    shard's partial output dropped (a planted fault) must fail it. Each
    call runs once untimed first."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import bf16_excess
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    t0 = time.perf_counter()
    out, params = {}, {}
    for i, (arch, shape) in enumerate(PAR_MOE):
        cfg = get_config(arch).replace(moe_impl="shard_map",
                                       act_dp=("data",))
        if arch not in params:
            params.clear()
            gc.collect()
            torch.cuda.empty_cache()
            params[arch] = L.moe_init(gen(torch, seed + 1420 + i), cfg,
                                      torch.bfloat16, DEV)
        p = params[arch]
        x = torch.randn((*PAR_MOE_TOKENS, cfg.d_model),
                        generator=gen(torch, seed + 1430 + i), device=DEV,
                        dtype=torch.float32).to(torch.bfloat16)
        mesh = make_host_mesh(*shape, devices=[torch.device(DEV, 0)]
                              * (shape[0] * shape[1]))
        tp = shape[1]
        ep = cfg.n_experts % tp == 0 and cfg.n_experts >= tp
        with torch.no_grad():
            scatter = cfg.replace(moe_impl="scatter")
            L.moe_apply(p, scatter, x, groups=shape[0])
            torch.cuda.synchronize()
            t = time.perf_counter()
            want, aux_w = L.moe_apply(p, scatter, x, groups=shape[0])
            torch.cuda.synchronize()
            one_ms = 1e3 * (time.perf_counter() - t)
            L.set_shard_mesh(mesh)
            real, calls, sq = L._moe_partial, [], []

            def keep_sums(*a, **kw):        # a data shard's tp calls in turn
                y, aux = real(*a, **kw)
                calls.append(1)
                if len(calls) % tp == 1 or tp == 1:
                    sq.append(torch.zeros_like(y, dtype=torch.float32))
                sq[-1] += y.float().abs()
                return y, aux

            def drop_one(*a, **kw):
                calls.append(1)
                y, aux = real(*a, **kw)
                return (torch.zeros_like(y) if len(calls) == 2 else y), aux
            try:
                L.moe_apply(p, cfg, x)
                torch.cuda.synchronize()
                t = time.perf_counter()
                got, aux = L.moe_apply(p, cfg, x)
                torch.cuda.synchronize()
                shard_ms = 1e3 * (time.perf_counter() - t)
                L._moe_partial = keep_sums
                L.moe_apply(p, cfg, x)
                calls.clear()
                L._moe_partial = drop_one
                bad, _ = L.moe_apply(p, cfg, x)
            finally:
                L._moe_partial = real
                L.set_shard_mesh(None)
        abs_sum = torch.cat(sq)         # each data shard's, in row order
        del sq
        ex = par_moe_excess(torch, got, want, abs_sum)
        fault = par_moe_excess(torch, bad, want, abs_sum)
        aux_d = abs(float(aux) - float(aux_w))
        key = f"{arch} {shape[0]}x{shape[1]}"
        out[key] = {"mode": "expert parallel" if ep else "ffn sliced",
                    "excess": ex, "fault_excess": fault, "aux_diff": aux_d,
                    "shard_map_ms": shard_ms, "groups_ms": one_ms}
        log(f"[parallel] (e) {arch} MoE layer at full width on a {shape} "
            f"virtual mesh ({out[key]['mode']}), {PAR_MOE_TOKENS[0]} x "
            f"{PAR_MOE_TOKENS[1]} tokens: {ex:.3g} of the limit of a sum "
            f"of bf16 partials ({bf16_excess(got, want, PAR_MOE_ROW_RTOL):.3g}"
            f" of the output's bf16 row limit) against "
            f"moe_apply(groups=2), aux {float(aux):.6f} vs "
            f"{float(aux_w):.6f}; one shard's partial dropped: {fault:.3g}; "
            f"host ms {shard_ms:.1f} per shard against {one_ms:.1f} in one "
            f"dispatch")
        check(bool(torch.isfinite(got.float()).all()),
              f"[parallel] (e) {key}: non-finite output")
        check(ex <= 1.0, f"[parallel] (e) {key}: {ex:.3g} of the limit")
        check(aux_d <= 1e-5 * max(1.0, abs(float(aux_w))),
              f"[parallel] (e) {key}: aux {float(aux)} vs {float(aux_w)}")
        check(fault > 1.0, f"[parallel] (e) {key}: the limit passes a "
                           f"dropped expert shard ({fault:.3g})")
        del x, want, got, bad, abs_sum
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def par_elastic(torch, np, seed: int) -> dict:
    """(f): ``ElasticRunner`` with the sharded step over PAR_ELASTIC
    virtual devices: a node loss, one remesh, checkpoints and
    ``resume()``; the end state against an uninterrupted run within the
    train tolerances (each leaf's largest difference of its largest |value|
    at TRAIN_GRAD_RTOL, the losses at TRAIN_LOSS_RTOL)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharded_train as st
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.fault_tolerance import (
        ElasticRunner, FaultInjector, reshard, to_host)
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt
    t0 = time.perf_counter()
    E = PAR_ELASTIC
    cfg = get_config(TRAIN_ARCH).reduced().replace(remat=False,
                                                   dtype="float32")
    optc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = lm.init_params(gen(torch, seed + 1440), cfg, DEV)
    specs_of = lambda fsdp: shd.param_specs(params, cfg, fsdp=fsdp)

    def run(injector, ckpt_dir=None):
        losses = []

        def make_step(mesh):
            sf = st.make_sharded_train_step(cfg, mesh, optc=optc,
                                            ce_chunk=E["L"])
            specs = specs_of(mesh.shape["data"] > 1)

            def step(state):
                s = state["opt"].step
                b = st.place_batch(synth_batch(
                    cfg, np.random.default_rng((seed, s)), E["B"], E["L"],
                    DEV), cfg, mesh)
                p, o, met = sf(state["params"], state["opt"], b)
                losses.append(float(met["loss"]))
                return {"params": p, "opt": o}

            def shard(host):
                return {"params": reshard(host["params"], specs, mesh),
                        "opt": opt.AdamWState(
                            int(host["opt"]["step"]),
                            reshard(host["opt"]["m"], specs, mesh),
                            reshard(host["opt"]["v"], specs, mesh))}

            def unshard(state):
                return {"params": to_host(state["params"]),
                        "opt": {"step": np.asarray(state["opt"].step),
                                "m": to_host(state["opt"].m),
                                "v": to_host(state["opt"].v)}}
            return step, shard, unshard
        zeros = opt.init_state(params)
        state0 = {"params": to_host(params),
                  "opt": {"step": np.zeros((), np.int32),
                          "m": to_host(zeros.m), "v": to_host(zeros.v)}}
        cm = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
        r = ElasticRunner(make_step, devices=[torch.device(DEV, 0)]
                          * E["devices"], model_parallel=1,
                          injector=injector, ckpt_manager=cm,
                          ckpt_every=E["ckpt_every"])
        return r, r.run(state0, n_steps=E["steps"]), losses
    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="elastic-", dir=ROOT / "build"))
    try:
        r, state, losses = run(FaultInjector({E["at"]: E["lose"]}), str(d))
        step, back = r.resume()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _, whole, whole_losses = run(FaultInjector())
    worst = 0.0
    for key in ("params", "m", "v"):
        a = state["params"] if key == "params" else state["opt"][key]
        b = whole["params"] if key == "params" else whole["opt"][key]
        for (path, x), (_, y) in zip(opt.tree_leaves(a), opt.tree_leaves(b)):
            worst = max(worst, par_leaf_rel(torch, x, y))
    loss_worst = max(abs(x - y) / abs(y) for x, y in
                     zip(losses, whole_losses))
    same = all(torch.equal(par_bits(torch, torch.as_tensor(x)),
                           par_bits(torch, y)) for (_, x), (_, y) in
               zip(opt.tree_leaves(back["params"]),
                   opt.tree_leaves(state["params"])))
    want_log = [f"step {E['at']}: remesh {E['devices']}->"
                f"{E['devices'] - E['lose']}"]
    check(r.log == want_log, f"[parallel] (f) log {r.log}")
    check(step == E["steps"] and same,
          f"[parallel] (f) resume() gave step {step}, the same params "
          f"{same}")
    check(worst <= TRAIN_GRAD_RTOL and loss_worst <= TRAIN_LOSS_RTOL,
          f"[parallel] (f) the elastic run ends {worst:.4g} (state) and "
          f"{loss_worst:.4g} (losses) from the uninterrupted one")
    out = {"log": r.log, "mesh": dict(r.mesh.shape), "losses": losses,
           "uninterrupted_losses": whole_losses, "state_rel": worst,
           "loss_rel": loss_worst, "resumed_step": step,
           "wall_s": time.perf_counter() - t0}
    log(f"[parallel] (f) ElasticRunner, reduced {TRAIN_ARCH} on "
        f"{E['devices']} virtual devices, {E['lose']} lost at step "
        f"{E['at']}: log {r.log}, mesh {out['mesh']}; losses "
        f"{[round(x, 5) for x in losses]}; the end state "
        f"{worst:.4g} of each leaf's largest from the uninterrupted run's, "
        f"losses within {loss_worst:.4g}; resume() at step {step}, the "
        f"same bits ({out['wall_s']:.1f} s)")
    return out


def phase_parallel(torch, np, seed: int) -> dict:
    """Phase 14: the parallel training plane on virtual meshes of the one
    card: placements (a), the sharded train step (b), the collectives on
    its gradients (c), the pipeline (d), the MoE dispatch per shard (e)
    and elastic training (f). The phase adds no kernel: the plane's own
    device work is torch ops, as the reference's is jnp; K4 and the
    attention backward run inside the steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS, remat=True)
    mesh = make_host_mesh(*PAR_MESH, devices=[torch.device(DEV, 0)]
                          * (PAR_MESH[0] * PAR_MESH[1]))
    params = lm.init_params(gen(torch, seed + 1400), cfg, DEV)
    placed, place = par_placements(torch, np, params, cfg, mesh)
    pipe = par_pipeline(torch, np, cfg, params, seed)
    box = {"params": params}
    del params
    step = par_step(torch, np, cfg, mesh, box, placed, seed)
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    moe = par_moe(torch, np, seed)
    elastic = par_elastic(torch, np, seed)
    wall = time.perf_counter() - t0
    log(f"[parallel] phase done in {wall:.1f} s ((a) {place['wall_s']:.1f}, "
        f"(d) {pipe['wall_s']:.1f}, (b)+(c) {step['wall_s']:.1f}, (e) "
        f"{moe['wall_s']:.1f}, (f) {elastic['wall_s']:.1f})")
    return {"placements": place, "step": step, "pipeline": pipe,
            "moe": moe, "elastic": elastic, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 15: the dry-run against the card, and the examples on it
# ---------------------------------------------------------------------------

# the dry-run's predicted peak of live bytes (``launch.dryrun.run_cell`` on
# the meta device) against ``torch.cuda.max_memory_allocated`` over the
# same step, written before the first read: within 10% of the prediction
# (the trace counts every storage the step makes and frees in its order;
# the card adds its kernels' scratch, cuBLAS's workspace and the
# allocator's 512-byte rounding)
DRYRUN_PEAK_RTOL = 0.10
# (script, arguments, the counters that must be above 0) at quick sizes;
# the embedder at 200 steps, where the port's initial weights widen the
# gap (at the reference's 60 they may not)
EXAMPLE_RUNS = (
    ("torch_quickstart.py", ("--backend", "pallas"), ("cosine_topk",)),
    ("torch_quickstart.py", ("--backend", "pallas_q8"), ("cosine_topk_q8",)),
    ("torch_serve_with_siso.py", ("--backend", "pallas"),
     ("cosine_topk", "flash_attention", "flash_attention_f32",
      "decode_attention")),
    ("torch_serve_with_siso.py", ("--backend", "pallas_q8"),
     ("cosine_topk_q8",)),
    ("torch_train_embedder.py", ("--steps", "200"),
     ("flash_attention_f32", "flash_attention_bwd_f32_one_pass")))


def dryrun_peaks(torch, np, train: dict, parallel: dict) -> dict:
    """(a): ``run_cell`` for each step phase 13 (b) ran (one device,
    ``make_train_step``, the cut configuration, B 1 x its tokens) and for
    phase 14 (b)'s sharded step (the (2, 2) virtual mesh traced whole, as
    the one card holds it), each prediction beside the measured peak and
    the bytes allocated as the step began; qwen3-14b's two held at
    DRYRUN_PEAK_RTOL. Then each trained kind's ``mfu``: ``model_flops`` of
    its cut configuration over (the traced step's busy s x 989e12), and
    the traced FLOPs' share of the same."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline, steps
    from repro_torch.launch.mesh import make_host_mesh
    meta = torch.device("meta")
    pol = steps.CellPolicy(ce_chunk=TRAIN_CE_CHUNK)
    runs = {TRAIN_ARCH: train["qwen3"], **train["kinds"]}
    out: dict = {}
    for arch, run in runs.items():
        cfg = train_cfg(arch)
        # a VLM's step takes its patch prefix beside the text tokens
        shape = ShapeConfig("train", run["seq"] + cfg.prefix_len, 1, "train")
        rec = dryrun.run_cell(arch, "train", None, "one", pol, cfg=cfg,
                              shape=shape)
        check(rec["status"] == "ok", f"[dryrun] {arch}: {rec.get('error')}")
        pred, meas = rec["live_bytes_per_device"], run["peak_bytes"]
        busy = run["trace"].get("busy_ms")
        mf = roofline.model_flops(cfg, shape)
        r = {"predicted_peak_bytes": pred, "measured_peak_bytes": meas,
             "peak_rel": (meas - pred) / pred,
             "predicted_args_bytes": rec["argument_bytes_per_device"],
             "measured_alloc_before_bytes": run["alloc_before_bytes"],
             "traced_flops": rec["flops_per_device"], "model_flops": mf,
             "busy_ms": busy, "trace_s": rec["trace_s"],
             "mfu": mf / (busy / 1e3 * H100_BF16_FLOPS) if busy else None,
             "traced_flops_share": rec["flops_per_device"]
             / (busy / 1e3 * H100_BF16_FLOPS) if busy else None}
        out[arch] = r
        log(f"[dryrun] (a) {arch} x {cfg.n_layers} layers, B 1 x "
            f"{run['seq']}, one device: predicted peak "
            f"{pred / 2**30:.2f} GiB, measured {meas / 2**30:.2f} GiB "
            f"({r['peak_rel']:+.4f}); arguments predicted "
            f"{r['predicted_args_bytes'] / 2**30:.2f} GiB, allocated as the "
            f"steps began {run['alloc_before_bytes'] / 2**30:.2f} GiB; mfu "
            + (f"{r['mfu']:.4f} ({mf:.4e} model FLOPs over {busy:.3f} busy "
               f"ms), traced FLOPs {r['traced_flops_share']:.4f} of peak"
               if busy else "not measured (no traced step)")
            + f"; trace {rec['trace_s']:.1f} s")
    qwen = out[TRAIN_ARCH]
    check(abs(qwen["peak_rel"]) <= DRYRUN_PEAK_RTOL,
          f"[dryrun] {TRAIN_ARCH}'s one-device step: measured peak "
          f"{qwen['measured_peak_bytes']} bytes, predicted "
          f"{qwen['predicted_peak_bytes']} ({qwen['peak_rel']:+.4f})")
    st = parallel["step"]
    cfg = train_cfg(TRAIN_ARCH)
    shape = ShapeConfig("train", PAR_BATCH[1], PAR_BATCH[0], "train")
    mesh = make_host_mesh(*PAR_MESH, devices=[meta] * (PAR_MESH[0]
                                                       * PAR_MESH[1]))
    rec = dryrun.run_cell(TRAIN_ARCH, "train", mesh, "2x2", pol, cfg=cfg,
                          shape=shape, whole_step=True)
    check(rec["status"] == "ok", f"[dryrun] sharded: {rec.get('error')}")
    pred, meas = rec["live_bytes_per_device"], st["step_peak_bytes"]
    sh = {"predicted_peak_bytes": pred, "measured_peak_bytes": meas,
          "peak_rel": (meas - pred) / pred,
          "predicted_args_bytes": rec["argument_bytes_per_device"],
          "measured_alloc_before_bytes": st["step_alloc_before_bytes"],
          "collective_by_op": rec["collective_by_op"],
          "traced_flops": rec["flops_per_device"], "trace_s": rec["trace_s"]}
    out["sharded"] = sh
    log(f"[dryrun] (a) phase 14 (b)'s sharded step, {TRAIN_ARCH} x "
        f"{cfg.n_layers} layers on the {PAR_MESH} virtual mesh, "
        f"{PAR_BATCH[0]} x {PAR_BATCH[1]}: predicted peak "
        f"{pred / 2**30:.2f} GiB, measured {meas / 2**30:.2f} GiB "
        f"({sh['peak_rel']:+.4f}); arguments predicted "
        f"{sh['predicted_args_bytes'] / 2**30:.2f} GiB, allocated as the step "
        f"began {st['step_alloc_before_bytes'] / 2**30:.2f} GiB; the plan's "
        f"wire bytes a device {rec['collective_by_op']}")
    check(abs(sh["peak_rel"]) <= DRYRUN_PEAK_RTOL,
          f"[dryrun] the sharded step: measured peak {meas} bytes, "
          f"predicted {pred} ({sh['peak_rel']:+.4f})")
    return out


def run_examples(torch) -> dict:
    """(b): each of EXAMPLE_RUNS as a subprocess on ``cuda``: its output
    lines logged, its last line's kernel launches read, each named
    counter above 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for script, args, need in EXAMPLE_RUNS:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script), "--device",
             "cuda", *args], cwd=str(ROOT), env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t
        tag = f"{script} {' '.join(args)}"
        for line in proc.stdout.splitlines():
            log(f"[examples] {tag}: {line}")
        check(proc.returncode == 0, f"[examples] {tag} exited "
                                    f"{proc.returncode}: {proc.stderr[-2000:]}")
        last = proc.stdout.strip().splitlines()[-1]
        check(last.startswith("kernel launches: "),
              f"[examples] {tag}: no launch line, last line {last!r}")
        launches = json.loads(last[len("kernel launches: "):])
        check(all(launches.get(k, 0) > 0 for k in need),
              f"[examples] {tag}: launches {launches}, {need} must be "
              f"above 0")
        log(f"[examples] {tag}: {wall:.1f} s, launches {launches}")
        out[tag] = {"launches": launches, "wall_s": wall,
                    "stdout": proc.stdout}
    return out


def phase_dryrun(torch, np, train: dict, parallel: dict) -> dict:
    """Phase 15: (a) the dry-run's predicted peaks beside the measured
    ones of phases 13 (b) and 14 (b), and each trained kind's ``mfu``;
    (b) the three examples on ``cuda`` (``EXAMPLE_RUNS``)."""
    t0 = time.perf_counter()
    peaks = dryrun_peaks(torch, np, train, parallel)
    t = time.perf_counter()
    examples = run_examples(torch)
    wall = time.perf_counter() - t0
    log(f"[dryrun] phase done in {wall:.1f} s ((a) {t - t0:.1f} s, the "
        f"examples {wall - (t - t0):.1f} s)")
    return {"peaks": peaks, "examples": examples, "wall_s": wall}


# ---------------------------------------------------------------------------
# timing, in a fresh process
# ---------------------------------------------------------------------------


def timing_child(torch, out_dir: str, seed: int) -> None:
    """``--timing-child DIR``: every kernel's timing (CUDA events and the
    profiler's device time) at the main path's shapes, in this fresh
    process, so that no earlier trace can drop a record of these
    (tools/profiler_probe.py): K1/K2, K4/K3 and their Dv mode, WKV6, K4/K3
    at Dh 112 and the attention backward. Fails if a timed call's trace
    recorded no kernel of its own. Writes DIR/timing.json and exits."""
    timing = phase_timing(torch, seed)
    timing.update(phase_attention_timing(torch, seed))
    timing["wkv6"] = wkv6_timing(torch, seed)
    timing.update(dh112_timing(torch, seed))
    timing.update(bwd_timing(torch, seed))
    for name, recs in timing.items():
        for rec in recs if isinstance(recs, list) else [recs]:
            check(not isinstance(rec, dict) or "device_ms" not in rec
                  or rec["device_ms"] is not None,
                  f"[timing] {name}: the profiler recorded no kernel of the "
                  f"timed call")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    write_json(Path(out_dir) / "timing.json", timing)
    sys.exit(0)


def run_timing_child(seed: int) -> dict:
    """The timings of ``timing_child``, taken in a child process of this
    script; its log lines go to this process's stdout. A failure fails the
    phase."""
    import os
    import shutil
    d = ROOT / "build" / f"timing-{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--timing-child", str(d), "--seed", str(seed)],
                          timeout=600)
    check(proc.returncode == 0,
          f"[timing] the timing child exited {proc.returncode}")
    timing = json.loads((d / "timing.json").read_text())
    shutil.rmtree(d, ignore_errors=True)
    log(f"[timing] every kernel timed in a fresh child process in "
        f"{time.perf_counter() - t0:.1f} s")
    return timing


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=SERVED_LAYERS,
                    help="the served qwen3-14b's depth (widths are never "
                         "cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results",
                    help="directory for chip_smoke.json, relative to the "
                         "repository root")
    ap.add_argument("--planes-child", metavar="DIR",
                    help=argparse.SUPPRESS)   # phase 7's killed process
    ap.add_argument("--replicas-child", metavar="SPEC",
                    help=argparse.SUPPRESS)   # phase 8's killed replicas
    ap.add_argument("--timing-child", metavar="DIR",
                    help=argparse.SUPPRESS)   # every kernel's timing
    ap.add_argument("--only", choices=["parallel"],
                    help="build the kernels and run this phase alone (no "
                         "result lines)")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.planes_child:
        from repro_torch.device import strict_fp32
        strict_fp32()
        planes_child(torch, np, args.planes_child, args.seed)
    if args.replicas_child:
        from repro_torch.device import strict_fp32
        sys.stdout = sys.stderr     # the parent's stdout carries its result
        strict_fp32()
        replicas_child(torch, np, args.replicas_child)
    if args.timing_child:
        from repro_torch.device import strict_fp32
        strict_fp32()
        timing_child(torch, args.timing_child, args.seed)
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    strict_fp32()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {smi}")
    detail = {"nvidia_smi": smi}
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(reports)} kernels built in {build_s:.1f} s "
        f"(nvcc per source, in parallel)")
    detail["build_s"] = build_s
    detail["bwd_bf16_ptxas"] = bwd_bf16_ptxas(
        reports.get("flash_attention_bwd"))
    detail["bwd_one_pass_ptxas"] = bwd_one_pass_ptxas(
        reports.get("flash_attention_bwd"))
    detail["bwd_tiled_f32_ptxas"] = bwd_tiled_f32_ptxas(
        reports.get("flash_attention_bwd"))
    detail["wkv6_bwd_ptxas"] = wkv6_bwd_ptxas(reports.get("wkv6_bwd"))
    detail["fwd_bf16_ptxas"] = fwd_bf16_ptxas(reports.get("flash_attention"))
    for name in _build.KERNELS:
        _build.load(name)
    if args.only == "parallel":
        parallel = phase_parallel(torch, np, args.seed)
        out_dir = ROOT / args.out
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke_parallel.json").write_text(json.dumps(
            {**detail, "parallel": parallel}, indent=1, default=str))
        log(f"[done] phase 14 alone passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    t = time.perf_counter()
    err = phase_kernels(torch, args.seed)
    agree = phase_attention_kernels(torch, args.seed)
    detail["planted_faults"] = phase_planted_faults(torch, args.seed)
    att_err = agree.err
    torch.cuda.empty_cache()        # the timing child's room
    timing = run_timing_child(args.seed)
    detail.update(max_abs_err={**err, **att_err}, timing=timing,
                  kernels_s=time.perf_counter() - t)
    t = time.perf_counter()
    detail["cache"] = phase_cache(torch, np, args.seed)
    detail["cache_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for kv_dtype in ("float32", "int8"):
        phase_engine_consistency(torch, np, args.seed, kv_dtype)
    models = build_models(torch, args.layers, args.seed)
    recorder = CallRecorder(ops)
    att_rec = (OpsRecorder(fa_ops), OpsRecorder(da_ops),
               OpsRecorder(wkv6_ops))     # WKV6's only in phase 12
    kept: dict = {}         # the served pallas SISO, for the shard phase
    serve = {b: serve_once(torch, np, b, models, recorder, att_rec,
                           args.seed, keep=kept if b == "pallas" else None)
             for b in ("pallas", "pallas_q8")}
    detail["serve"] = serve
    detail["serve_s"] = time.perf_counter() - t
    t = time.perf_counter()
    long_runs = {kv: phase_engine_long(torch, np, models, att_rec,
                                       args.seed, kv)
                 for kv in ("bfloat16", "int8")}
    detail["engine_long"] = long_runs
    detail["engine_long_s"] = time.perf_counter() - t
    t = time.perf_counter()
    slo_sim = phase_slo_simulator(torch, np)
    sim_s = time.perf_counter() - t
    slo_live = phase_slo_gateway(torch, np, models, recorder, att_rec,
                                 args.seed)
    detail["slo"] = {"simulator": slo_sim, "gateway": slo_live}
    detail["slo_s"] = time.perf_counter() - t
    log(f"[slo] phase done in {detail['slo_s']:.1f} s (simulator "
        f"{sim_s:.1f} s, live gateway {detail['slo_s'] - sim_s:.1f} s)")
    planes = phase_planes(torch, np, models, recorder, att_rec, args.seed)
    detail["planes"] = planes
    detail["planes_s"] = planes["wall_s"]
    replicas = phase_replicas(torch, np, models, recorder, att_rec,
                              args.seed)
    child_att = replicas.pop("child_att_calls")
    detail["replicas"] = replicas
    detail["replicas_s"] = replicas["wall_s"]
    shard = phase_shard(torch, np, models, kept, recorder, att_rec,
                        args.seed)
    del kept
    detail["shard"] = shard
    detail["shard_s"] = shard["wall_s"]
    del models          # the qwen3 weights: the zoo's models need the room
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(torch, np, att_rec, args.seed)
    detail["zoo"] = zoo
    detail["zoo_s"] = zoo["wall_s"]
    gc.collect()
    torch.cuda.empty_cache()
    mla = phase_mla_encdec(torch, np, att_rec, args.seed)
    detail["mla_encdec"] = mla
    detail["mla_encdec_s"] = mla["wall_s"]
    gc.collect()
    torch.cuda.empty_cache()
    ssm = phase_ssm_hybrid(torch, np, att_rec, args.seed)
    agree.merge(ssm.pop("agreement"))
    detail["ssm_hybrid"] = ssm
    detail["ssm_hybrid_s"] = ssm["wall_s"]
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(torch, np, args.seed)
    detail["train"] = train
    detail["train_s"] = train["wall_s"]
    main_err = phase_main_shapes(torch, recorder.calls, args.seed)
    err["cosine_top1_local"] = shard["kernel"]["max_abs_err"]
    check({c[0] for c in recorder.calls} == set(err),
          "[kernels] a kernel of the main path was never called")
    att_calls = att_rec[0].distinct() | att_rec[1].distinct() | child_att
    check({c[0] for c in att_calls} == {"flash_attention",
                                        "decode_attention"},
          "[kernels] an attention kernel of the main path was never called")
    check(any(c[0] == "decode_attention" and c[2] == LONG_MAX
              for c in att_calls),
          "[kernels] engine-long's K3 calls were not recorded")
    agree.merge(phase_attention_main_shapes(torch, att_calls, args.seed))
    err = {fn: max(err[fn], main_err.get(fn, 0.0)) for fn in err}
    att_err = agree.err
    detail.update(max_abs_err={**err, **att_err},
                  bf16_limit_share=agree.share,
                  main_path_calls=sorted(recorder.calls),
                  main_path_attention_calls=sorted(att_calls, key=repr))
    gc.collect()
    torch.cuda.empty_cache()
    parallel = phase_parallel(torch, np, args.seed)
    detail["parallel"] = parallel
    detail["parallel_s"] = parallel["wall_s"]
    gc.collect()
    torch.cuda.empty_cache()
    dry = phase_dryrun(torch, np, train, parallel)
    detail["dryrun"] = dry
    detail["dryrun_s"] = dry["wall_s"]

    main_b = 4      # the served batch size, the one the kernels line times
    timed_n = {name: N_ROWS for name in err}
    timed_n["cosine_top1_local"] = shard["kernel"]["timing"]["N"]
    for name in err:
        check(any(c[:3] == (name, main_b, timed_n[name])
                  for c in recorder.calls),
              f"[kernels] {name}: the main path never ran B={main_b} at "
              f"N={timed_n[name]}, the shape that is timed")
    replaces = {
        "cosine_topk": "src/repro/kernels/cosine_topk/kernel.py:49",
        "cosine_top1_local": "src/repro/kernels/cosine_topk/ops.py:222",
        "cosine_topk_q8": "src/repro/kernels/cosine_topk/kernel.py:98",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:19",
        "flash_attention_f32":
            "src/repro/kernels/flash_attention/kernel.py:19",
        "decode_attention": "src/repro/kernels/decode_attention/kernel.py:25",
        "decode_attention_int8":
            "src/repro/kernels/decode_attention/kernel.py:25",
        # the Dv mode, which the Pallas kernels lack, is held against the
        # reference model layer's jnp attention (src/repro/models/
        # layers.py:157 and :252), which MLA calls
        "flash_attention_dv": "src/repro/kernels/flash_attention/kernel.py:19",
        "decode_attention_dv":
            "src/repro/kernels/decode_attention/kernel.py:25",
        # no Pallas kernel: the reference's jnp step scan, which XLA
        # compiles into one loop on the TPU
        "wkv6": "src/repro/models/ssm.py:93",
        # no Pallas VJP: the reference differentiates its jnp attention
        "flash_attention_bwd_dq": "src/repro/models/layers.py:157",
        "flash_attention_bwd_dkv": "src/repro/models/layers.py:157",
        "flash_attention_bwd_dq_f32": "src/repro/models/layers.py:157",
        "flash_attention_bwd_dkv_f32": "src/repro/models/layers.py:157",
        "flash_attention_bwd_f32": "src/repro/models/layers.py:157",
        **{f"flash_attention_bwd_{part}_{mode}":
           "src/repro/models/layers.py:157"
           for part in ("dq", "dkv") for mode in ("dv", "wide", "wide192")},
        # no Pallas kernel and no VJP: the reference differentiates its jnp
        # step scan
        "wkv6_bwd": "src/repro/models/ssm.py:93",
        # K5 with the checkpoints its backward restarts from
        "wkv6_ckpt": "src/repro/models/ssm.py:93",
        # K4-Dv with the LSE its backward's exact-width pair reads: the
        # reference differentiates its jnp attention
        "flash_attention_dv_lse": "src/repro/models/layers.py:157"}
    sources = {
        "cosine_topk": "src/repro_torch/csrc/cosine_topk.cu",
        "cosine_top1_local": "src/repro_torch/csrc/cosine_topk.cu",
        "cosine_topk_q8": "src/repro_torch/csrc/cosine_topk_q8.cu",
        "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
        "flash_attention_f32": "src/repro_torch/csrc/flash_attention.cu",
        "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
        "decode_attention_int8": "src/repro_torch/csrc/decode_attention.cu",
        "flash_attention_dv": "src/repro_torch/csrc/flash_attention.cu",
        "decode_attention_dv": "src/repro_torch/csrc/decode_attention.cu",
        "wkv6": "src/repro_torch/csrc/wkv6.cu",
        "flash_attention_bwd_dq": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "flash_attention_bwd_dkv":
            "src/repro_torch/csrc/flash_attention_bwd.cu",
        "flash_attention_bwd_dq_f32":
            "src/repro_torch/csrc/flash_attention_bwd.cu",
        "flash_attention_bwd_dkv_f32":
            "src/repro_torch/csrc/flash_attention_bwd.cu",
        "flash_attention_bwd_f32":
            "src/repro_torch/csrc/flash_attention_bwd.cu",
        **{f"flash_attention_bwd_{part}_{mode}":
           "src/repro_torch/csrc/flash_attention_bwd.cu"
           for part in ("dq", "dkv") for mode in ("dv", "wide", "wide192")},
        "wkv6_bwd": "src/repro_torch/csrc/wkv6_bwd.cu",
        "wkv6_ckpt": "src/repro_torch/csrc/wkv6.cu",
        "flash_attention_dv_lse": "src/repro_torch/csrc/flash_attention.cu"}
    # launches on the main path: K1/K2 in their served stream, the slo
    # phase's runs, the planes phase (its killed child included), the
    # replicas phase (its children and the launcher's workers included)
    # and the shard phase, where K1-local runs; K3/K4 in both served
    # streams, both engine-long runs, the slo phase's live gateway, the
    # planes phase's gateway restart, the replicas phase, the shard
    # phase's gateways, the zoo phase's mixtral and paligemma runs, the
    # mla_encdec phase's minicpm3, deepseek-v2 and whisper runs (the Dv
    # mode's only there) and the ssm_hybrid phase's zamba2 run
    launches = {"cosine_topk": serve["pallas"]["launches"]
                + slo_sim["launches"]["cosine_topk"]
                + slo_live["launches"]["cosine_topk"]
                + planes["launches"]["cosine_topk"]
                + replicas["launches"]["cosine_topk"]
                + shard["launches"]["cosine_topk"],
                "cosine_top1_local": shard["launches"]["cosine_top1_local"],
                "cosine_topk_q8": serve["pallas_q8"]["launches"]
                + slo_sim["launches"]["cosine_topk_q8"]
                + planes["launches"]["cosine_topk_q8"]
                + replicas["launches"]["cosine_topk_q8"]
                + shard["launches"]["cosine_topk_q8"]}
    for name in att_err:
        launches[name] = sum(r["attention_launches"][name]
                             for r in serve.values()) + sum(
            r["launches"][name] for r in long_runs.values()) \
            + slo_live["launches"][name] + planes["launches"][name] \
            + replicas["launches"][name] + shard["launches"][name] \
            + zoo["launches"][name] + mla["launches"][name] \
            + ssm["launches"][name] + train["launches"][name]
        check(launches[name] > 0, f"[kernels] {name} was never launched on "
                                  f"the main path")
    # WKV6: phase 12's rwkv6 engine run and phase 13's rwkv6 training
    launches["wkv6"] = ssm["launches"]["wkv6"] + train["launches"]["wkv6"]
    check(launches["wkv6"] > 0, "[kernels] wkv6 was never launched on the "
                                "main path")
    # the backward: phase 13's training steps and trainers; bf16 calls (in
    # (b)'s steps and launch.train) launch a pair, (a) and (b): the wgmma
    # pair at its padded widths (qwen3, the reduced models, the reduced
    # MLA's (24, 16)), the exact-width pair at <96, 64> from the forward's
    # LSE (``_dv``: minicpm3-4b), the wide pair at
    # <256, 256> (``_wide``: paligemma-3b); the f32 ones (the embedder's)
    # the one-pass kernel; K5-bwd rwkv6-7b's. No call of the main path
    # reaches the tiled f32 pair (phase_train checks it) or the wide pair's
    # <192, 128> instance (``_wide192``: deepseek-v2's widths, whose
    # training step does not fit the card), so their launches are 0 and
    # exempt from the check; phase 13 (a)'s sweep launches are their
    # ``sweep_launches``
    tl = train["launches"]
    n_bf16 = tl["flash_attention_bwd"] - tl["flash_attention_bwd_f32"] \
        - tl["flash_attention_bwd_exact"] - tl["flash_attention_bwd_wide"]
    sweep_only = ("flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32",
                  "flash_attention_bwd_dq_wide192",
                  "flash_attention_bwd_dkv_wide192")
    for part in ("dq", "dkv"):
        launches[f"flash_attention_bwd_{part}"] = n_bf16 // 2
        launches[f"flash_attention_bwd_{part}_dv"] = \
            tl["flash_attention_bwd_exact"] // 2
        launches[f"flash_attention_bwd_{part}_wide"] = \
            tl["flash_attention_bwd_wide"] // 2
        launches[f"flash_attention_bwd_{part}_f32"] = 0
        launches[f"flash_attention_bwd_{part}_wide192"] = 0
    launches["flash_attention_bwd_f32"] = \
        tl["flash_attention_bwd_f32_one_pass"]
    launches["wkv6_bwd"] = tl["wkv6_bwd"]
    launches["wkv6_ckpt"] = tl["wkv6_ckpt"]
    launches["flash_attention_dv_lse"] = tl["flash_attention_lse"]
    for name in [n for n in launches if (n.startswith("flash_attention_bwd")
                                         or n in ("wkv6_bwd", "wkv6_ckpt",
                                                  "flash_attention_dv_lse"))
                 and n not in sweep_only]:
        check(launches[name] > 0, f"[kernels] {name} was never launched on "
                                  f"the main path")
    # timed at the main path's shapes: K1/K2 at the served batch; K4 at the
    # engine's 4,096-token prefill; K3 at engine-long's kv length
    timed = {name: next(r for r in timing[name] if r["B"] == main_b)
             for name in ("cosine_topk", "cosine_topk_q8")}
    timed["cosine_top1_local"] = shard["kernel"]["timing"]
    timed["flash_attention"] = timing["flash_attention/prefill"]
    timed["flash_attention_f32"] = timing["flash_attention/embedder"]
    timed["decode_attention"] = \
        timing[f"decode_attention/{LONG_MAX}/{LONG_PROMPT}"]
    timed["decode_attention_int8"] = \
        timing[f"decode_attention_int8/{LONG_MAX}/{LONG_PROMPT}"]
    # the Dv mode at minicpm3's prefill and decode shapes
    timed["flash_attention_dv"] = timing["flash_attention_dv/prefill"]
    timed["decode_attention_dv"] = \
        timing["decode_attention_dv/{}/{}".format(*DV_DECODE_TIMED)]
    # WKV6 at rwkv6-7b's prefill; the bf16 backward pair at qwen3-14b's
    # prefill, the f32 pair at phase 13 (a)'s 1,024 tokens, the one-pass
    # kernel at the embedder's call
    timed["wkv6"] = timing["wkv6"]
    # the new backward modes at their main-path widths, B 1 x 4,096:
    # minicpm3-4b's (96, 64) (``_dv``), paligemma-3b's 256 with its prefix
    # at its step's 4,352 tokens (``_wide``), deepseek-v2's (192, 128)
    # (``_wide192``); K5-bwd and the checkpointing K5 at rwkv6-7b's 64
    # heads of 64, B 1 x 4,096
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32",
                 "flash_attention_bwd_f32", "wkv6_bwd", "wkv6_ckpt",
                 "flash_attention_dv_lse",
                 *(f"flash_attention_bwd_{part}_{mode}"
                   for mode in ("dv", "wide", "wide192")
                   for part in ("dq", "dkv"))):
        timed[name] = timing[name]
    one_err = train["kernels"]["err"]["one_pass"]
    all_err = {**err, **att_err, "wkv6": ssm["wkv6_max_abs_err"],
               **{f"flash_attention_bwd_{part}{sfx}":
                  train["kernels"]["err"][dt][part]
                  for part in ("dq", "dkv")
                  for sfx, dt in (("", "bfloat16"), ("_f32", "float32"),
                                  ("_dv", "dv"), ("_wide", "wide"),
                                  ("_wide192", "wide192"))},
               "flash_attention_bwd_f32": max(one_err["dq"],
                                              one_err["dkv"]),
               "wkv6_bwd": train["kernels"]["wkv6_bwd"]["err"],
               "wkv6_ckpt": train["kernels"]["wkv6_bwd"]["ckpt_err"],
               "flash_attention_dv_lse": train["kernels"]["lse"]["err"]}
    kernels = []
    for name, rec in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": all_err[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        for key in ("device_ms", "library_device_ms", "parent_device_ms",
                    "no_ckpt_device_ms", "no_lse_device_ms"):  # profiler
            if key in rec:
                kernels[-1][key] = rec[key]
        if name in sweep_only[:2]:
            kernels[-1]["sweep_launches"] = \
                train["kernels"]["launches"]["tiled_f32"] // 2
        elif name in sweep_only:
            kernels[-1]["sweep_launches"] = \
                train["kernels"]["calls"]["wide192"]
    detail["total_s"] = time.perf_counter() - t_start
    log(f"[done] every phase passed in {detail['total_s']:.1f} s")
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"kernels": kernels, **detail}, indent=1, default=float))
    print(smi)      # the card's name and power limit, as nvidia-smi says
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
