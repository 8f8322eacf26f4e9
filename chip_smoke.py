"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): build, check, drive.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and never
prints the final line:

1. Device: requires CUDA (there is no CPU path); prints the card's name and
   power limit; turns TF32 off for matmuls and cuDNN.
2. Build: compiles the CUDA kernels from ``leaxer_qwen3_tts_torch/csrc``.
3. K1 (``fused_decode_step``) against its plain PyTorch version at the 0.6B
   talker shapes (28 layers, H=1024, int8, bf16 cache) at T=256 and T=2560,
   at the MTP trunk shapes (6 layers, T=17), and on 1 talker layer, where
   rounding cannot cascade, with a float32 and a bf16 cache at every bucket
   and at the attention's split edges: 24 seeded inputs per case, each within
   flip-tolerant limits and at least 8 of them agreeing to 1e-5.  Beside it,
   K4 (``fused_decode_step_batched``) on the same packs: the talker at B=8
   and B=32 (T=512, per-row positions on both sides of a split edge, one past
   the bucket, the last slot), the MTP trunk shape at B=8, and one layer at
   B=2, 8 and 32 with both caches (24 seeded batches, the K1 limits, a third
   of the rows tight); every row of K4 must equal K1 on it bit for bit.  Then
   K6 (``fused_verify_step``): S=4 at B=1 (T=256 and 512), 8 x 3 and 4 x 8
   rows at full depth, and S in {2, 4, 8} at B in {1, 4} on one layer with
   both caches, starts at 0, across a split edge, at T - S and past it; the
   K1 limits and tight share, and every row equal bit for bit to the S
   successive K1 (B=1) or K4 steps it stands for.  K6 is one persistent
   cooperative launch per pass (K4's transport and a slot-write phase): on
   every one of those inputs, and on one more per deep case with each cache
   dtype and per shallow case with a one-slot ring, x and both caches equal
   the launch-per-op pass it replaced (``qtts_verify_step_multi``) bit for
   bit, also with every slot write stalled 20 us (the slot-write barrier
   must hold the readers); it is timed against it in turns and traced once.  K1 is one persistent
   cooperative launch per step: it is held bit for bit (x and both caches)
   to the launch-per-op sequence it replaced (``qtts_decode_step_multi``) at
   the 0.6B talker (T=256 and 2560, the first slot, split edges, the last
   slot) and MTP trunk (T=17) widths with bf16 and float32 caches, timed
   against it in turns (sequence, persistent, persistent, sequence), and
   traced once (per-barrier ``%globaltimer`` marks: each phase's input,
   weight wait, dot products and refill, and the grid barrier's latency).
4. K2 (``fused_mtp_chain``) against its plain version at the 0.6B MTP shapes,
   greedy and sampled, on the same noise; the persistent K2 against the
   launch-per-op chain it replaced (``qtts_mtp_chain_multi``) bit for bit on
   16 seeded inputs per knob set of K5_KNOBS and cache dtype, timed in turns
   and traced.  K1 and K2 are held to the launch sequences once more on a
   few inputs with a one-slot weight ring (``one_slot_ring``), where each
   stage's copy is issued just before it is read, so that a consumer that
   does not wait on its stage's mbarrier reads bytes still in flight (with
   the default ring the copy has landed).  Then K5 (``fused_mtp_chain_batched``)
   at B=8 and B=16 against its plain version with mixed per-row knobs (K2's
   margin rule for a mismatch), and at B=2, 8 and 32 every row equal to K2
   on that row's noise, bit for bit.
5. K7 (``fused_frame_step``, one persistent cooperative launch per frame on
   a plan of two weight sets) at the 0.6B widths, T=256 and 2560, at a split
   edge and the last slot, greedy and two sampled knob sets, 16 seeded inputs
   each with a bf16 cache (4 or 2 with a float32 cache, 2 with a one-slot
   ring): its code0 is the plain sampler's pick on the same logits and
   noise; code0, the sub-codes, c0e, sub_sum, x, talker caches, hidden and
   logits equal the launch-per-op frame kernel's (``qtts_frame_step_multi``)
   bit for bit, and all but code0 equal the composition K2 -> float32 next
   input -> K1 -> K1's GEMV body on the final norm (``qtts_norm_head``);
   timed in turns with the launch-per-op frame and traced once; against its
   plain version, K1's deep limits and K5's flip rule; timed beside the
   composition.  Then the probes' ring kernel against the group kernel it
   replaced (``qtts_unit_probe``, run only by these checks): P1's every arm,
   P2's both arms, bit for bit on the short and the whole chain (P2 also
   with a one-slot ring whose stages are issued late), and in turns with
   it; then the probes P1 and P2 (``tools/a8_probe.py``,
   ``tools/w8a8_probe.py``) through their ``run`` entries: every arm against
   its plain version and timed beside one PyTorch call of the unit product,
   both on the ring kernel alone.
6. Slice: ``TTSEngine.synthesize`` (0.6B preset, random weights from a seed,
   int8) on three requests, then a fixed FIXED_FRAMES-frame run through the generate
   callables and the engine's cache growth (256 -> 512 slots), with any host
   sync inside a decode chunk raising.  Launch counters, reset just before,
   must show one K1 step and one K2 chain per decoded frame.  Then
   ``TTSEngine(frame_fused=True)``: the same three requests and a streamed
   one, one K7 launch per decoded frame and no K1 or K2; fixed FIXED_FRAMES-
   frame runs in turns with the multi-dispatch engine (multi, K7, K7, multi);
   greedy agreement with it printed as data; a ``torch.profiler`` trace of
   single frames of both (device busy, idle share).
7. Batched slice: ``synthesize_batch`` on 8 texts with per-stream seeds, then
   fixed FIXED_FRAMES-frame batched runs at B=8 and B=32 (EOS forbidden,
   a host sync inside a chunk raising): ms per batched frame, aggregate RTF.
   One K4 step and one K5 chain per decoded frame, no K1 or K2.
8. Pool: a ``ContinuousBatcher`` of 8 slots serves 12 requests (mixed
   languages and lengths, one streamed): TTFA and aggregate RTF; greedy pool
   output equals B=1 ``synthesize``; a seeded request gives the same codes
   alone and among co-tenants; two requests through ``make_http_server``; a
   second pool runs every chunk with host syncs raising.  One K4 and one K5
   per pooled frame; K1 and K2 only for the streamed request's bootstrap.
   Then a soak (``pool_soak``): the CPU soak's randomized schedule
   (tests/test_torch_pool_soak.py, SOAK_REQUESTS requests: overlong texts
   rejected, streams, greedy and sampled, 1-6 frames, three seeds) through
   8 slots, every repeat of a request's key decoding its codes again
   whatever shares the pool, streamed chunks equal to the retired audio, the
   queue drained and every admitted request counted.
9. Speculative decoding (spec_k=4, 4 iterations per dispatch; K5 is
   also checked and timed at the 4 rows of a B=1 iteration): greedy
   ``synthesize`` with the repeat draft, through the adaptive fallback, and
   with a trained-draft head (random weights) equals sequential
   ``synthesize``; the replay draft of the greedy trajectory commits 4
   frames every iteration with the codes equal; ms per committed frame at
   full acceptance (``force_accept``) and with the repeat draft, beside the
   sequential ms/frame, and a profile of one dispatch (device busy and idle
   share, top kernels); ``synthesize_batch`` at B=4 equals sequential per
   stream; a spec pool (8 slots x 3 candidates, 2 iterations per chunk)
   serves 12 requests, its greedy output equals B=1 ``synthesize``, a seeded
   request is the same alone and among co-tenants, and a second spec pool
   runs every chunk with host syncs raising while its fallback fires.  One
   K6 and one K5 per verify iteration; K2 for each frame 0 at B=1.  On
   every main path no launch-per-op entry (``qtts_*_multi``) runs: the
   library's entries are counted where the wrappers call them.
10. Entry points, at the 0.6B preset's full width: the port's
   ``save_checkpoint`` writes a checkpoint directory (random bf16 weights
   from a seed with a speaker encoder, ~1.7 GB of npz, and the byte-level
   tokenizer files); ``load_checkpoint`` reads it back bit for bit (save and
   load seconds and GB/s printed); ``TTSEngine(<dir>, quantize="int8")``
   decodes the greedy codes of the engine built on the same params; the CLI
   runs in this process (``cli.main``, so the launch counters see it) on the
   directory with ``--quantize int8``: one-shot, ``--frame-fused on``,
   ``--stream``, ``--ref`` (a 3 s WAV made from the first run's audio) and
   ``--spec-k 4`` exit 0 with a mono
   16-bit 24 kHz WAV, one K1 and one K2 per decoded frame (one K7 under
   ``--frame-fused on``; one K6 and one K5 per verify iteration and K2 for
   frame 0 under ``--spec-k``) and no launch-per-op entry; without
   ``--quantize`` (bf16 units) it exits 0 with a WAV, one K1 and one K3
   per decoded frame; ``--quantize int8 --kv-quant`` and ``--kv-quant``
   alone (the int8 KV cache) exit 0 with a WAV, one K1 and one K2 (K3) per
   frame; ``--quantize int4 --spec-k 4`` and, without ``--quantize``,
   ``--mtp-quantize int4 --spec-k 4`` exit 0 with a WAV (K6 and K5 per
   verify iteration).  The speaker embedding of
   that WAV on the card is within SPK_REL of the same checkpoint's on the
   CPU (ms per call printed).  The server
   (``python -m leaxer_qwen3_tts_torch.serve``) runs as four subprocesses
   booting at once, with ``--quantize int8``, without it (bf16 units), with
   ``--kv-quant`` alone and with ``--quantize int4``: its warmup seconds,
   two requests (``/synthesize``: a WAV; ``/synthesize_stream``: 16-bit
   PCM), exit 0 on SIGINT, each step under a stated timeout.  Last,
   one ``synthesize`` with ``QTTS_PROFILE`` set writes a Chrome trace that
   holds the ``synthesize`` range and K1's and K2's kernels by name.
11. The 1.7B voice slice (``QWEN3_TTS_17B`` with the talker's
   ``attn_impl="pallas"``, random weights made on the card from a seed, int8,
   bf16 KV cache, a random [9, 2048] speaker table): K1 at the 1.7B widths
   (28 layers, and one layer with 24 seeded inputs per float32 / bf16 case
   under the tight-input count), the persistent K1 against its launch
   sequence at T=256, K4 and K6 (B=1 x S=4 at T=256, 4 x 8 at T=512, both
   caches) against their launch sequences and the K1 / K4 steps bit for
   bit, and the persistent K2 against its launch-per-op chain
   on the 1.7B trunk (bf16 cache) bit for bit; K3 (``fused_mtp_chain_streamed``,
   K2's persistent chain on a float32 cache) against its plain version,
   greedy and two sampled knob sets, and against its launch-per-op chain
   (``qtts_mtp_chain_streamed_multi``) and K2 with a float32 cache on 16
   seeded inputs (and 2 with a one-slot ring), bit for bit, timed in turns
   with the launch-per-op chain and traced once;
   K8 (``flash_attend``) against its plain version at the 1.7B prefill shape
   and on random GQA shapes (g = 1 to 8, S = 1) with invalid keys, ragged S
   and T, rows masked everywhere beside rows that are not (against the
   closed form sum v / Tp too) and every allowed key in the last key tile;
   float32 within K8_F32_ABS, bf16 within K8_BF16_REL and with at most
   K8_BF16_FLIPS of the outputs off the plain version's bf16 value; timed
   beside ``scaled_dot_product_attention``; then
   ``synthesize(instruct=...)`` and ``synthesize_speaker("serena")`` through
   the engine and a fixed FIXED_FRAMES-frame instruct run: one K1 and one K3 per
   decoded frame, no K2, and 28 K8 launches per prefill.  With
   ``QTTS_MTP_STREAM=0`` (the streamed chain off) the same engine decodes a
   request on the per-step chain: one K1 per chain position, no K3.
12. bf16 weight units (``quantize`` unset, the CLI's and the server's
   default; bits=16 packs: raw weights as bf16 with scales of one).
   Anchors: K1 (0.6B talker at T=256 and 2560, split edges and the last
   slot; MTP trunk; the 1.7B talker), K4 (B=8 and 32), K3 and K5 (greedy and
   two sampled knob sets; the 1.7B trunk's K3) on bf16 twins of int8 packs
   (the int8 values as bf16, unit scales on both) equal the int8 kernels bit
   for bit (x and both caches; sub-codes and sub_sum); on real bf16 packs
   K4 rows equal K1 and K5 rows (on K3's float32 cache) equal K3 bit for
   bit; K1 / K4 / K3 / K5 against their plain versions with the int8
   kernels' limits (K1's deep and one-layer limits and tight count, K3's and
   K5's flip rule); one pass on a one-slot ring.  Then ``TTSEngine(config,
   params)`` with ``quantize`` unset at the 0.6B preset: three requests and
   a fixed FIXED_FRAMES-frame run (one K1 and one K3 per frame, no K2), the same with
   ``frame_fused=True`` (no K7: JAX's frame gate refuses bf16 trunks),
   phase 7's and phase 8's runs (one K4 and one K5 per frame; the greedy
   pool output equals B=1 ``synthesize``), and the 1.7B preset at B=1 (one
   K1 and one K3 per frame, 28 K8 per prefill).  Then B17 at the 1.7B
   widths: the batched plans (48 KB slots, batch groups) printed; K4 (B=8
   and 32), K6 (1 x 4, 4 x 8) and K5 (B=8 and 32, K3's float32 cache) on
   the engine's bf16 packs against their plain versions, K4 rows equal to
   K1, K6 rows to the steps and K5 rows to K3 bit for bit, on a one-slot
   ring and a narrow one; ``synthesize_batch`` and a pool of 8 at bf16 and
   int8 units (greedy pool output equal to B=1), greedy ``spec_k=4`` equal
   to sequential decoding, and the server from a 1.7B checkpoint without
   ``--quantize``.  Each figure is printed beside the int8 one of this run.
13. ``kvq_phase``: the int8 KV cache (``kv_quant=True``: int8 K/V with a
   float32 scale per (slot, kv head)).  K1 at T=256 and 2560 (28 layers,
   and one layer at the first slot, the split edges and the last slots with
   24 seeded inputs each under the flip-tolerant limits and the tight count:
   x within K1_TIGHT_REL and the written int8 slot equal), K4 at B=8 and
   32 (T=512), K6 at 1 x 4 (T=256), 8 x 3 and 4 x 8 (T=512) and K7 at
   T=256 and 2560, greedy and sampled, against their plain versions (the
   written slots dequantized, every other slot and scale untouched; K6 also
   with every slot write stalled 20 us); the quantization on exact ties (v / scale = k + 1/2) in K1, K4 and K6 bit
   for bit with the plain version (half to even); every K4 row equal to K1
   and every K6 row to the K1 / K4 steps it stands for, K7 equal to K2 ->
   float32 x -> K1 -> norm+lm_head, and K1 / K4 on bf16 twins of int8 packs
   equal to the int8 packs, all bit for bit (values and scales), again on a
   one-slot ring.  Then the 0.6B engines: fixed FIXED_FRAMES-frame B=1 runs in turns
   with a bf16 cache (int8 and bf16 units), greedy B=1 equal to spec_k=4
   greedy, ``frame_fused`` (one K7 per frame), spec_k=4 at full and zero
   acceptance, ``synthesize_batch`` at B=8 and 32 and a pool of 8 (int8 and
   bf16 units, greedy pool output equal to B=1), and the 1.7B preset at B=1
   (K1 kvq at its widths, an instruct request and a fixed FIXED_FRAMES-frame run);
   every run's launch counts, and K1, K4, K6 and K7 launched on them.
14. ``tp_phase``: the tensor-parallel path on a mesh that lists this card
   ``tp`` times (``make_mesh(1, tp, devices=[cuda:0] * tp)``: tp logical
   ranks), at the 0.6B widths (tp=2) and the 1.7B widths (tp=4).  K9 (one
   launch per step for the card's ranks: K1's phases on each rank's rows, the
   partials all-reduced in the kernel) at tp=1 (four layers) against K1 on
   K1's pack of the same weights, bit for bit, bf16 and float32 caches, and
   with every peer's rows zero against K1 on rank 0's shard, bit for bit; the
   K9 step against the step on the plain halves at T=256 pos 200 and T=2560
   pos 2559 (K1's deep limits, timed in ms per step, every rank's x the same
   bits) and traced (rank 0's phases, group barriers and exchanges; K10 too);
   two calls with the odd ranks' sends stalled equal the unstalled step bit
   for bit; a planted timeout raises and the next call is clean; K9 on
   one-layer shards, bf16 and float32 caches, 24 seeded inputs per case (K1's
   one-layer limits and 8 tight); K10 against its plain version (which rounds
   and sums as the kernel does), int8 and bf16 heads, greedy and two sampled
   knob sets: every rank's sub-codes and final residual and the sub_sum equal
   bit for bit, no exchange timed out; K10 twice in a row with every odd
   rank's sends stalled K10_STALL_NS (a wait a stale flag satisfies then reads
   the previous call's values) and on the drawn-anew scales; a planted timeout
   (the sends held past the wait limit) raises, and the next call is clean; K9
   and K10 again on a one-slot ring.  Then ``TTSEngine(config, params,
   mesh=...)`` with ``quantize`` unset: two 0.6B requests at tp=2 and one 1.7B
   request at tp=4, one K9 and one K10 launch per decoded frame and no other
   kernel.  Then the meshes whose B=1 routes mix a kernel and a plain route
   (``mesh_route_runs``, MESH_KERNEL_FRAMES frames each, as JAX's gates
   route them): 0.6B tp=2 with ``kv_quant`` (the plain step on the int8
   cache beside K10: K10 per decoded frame and device, no K9), 1.7B tp=2 (K9
   beside the cached chain, the trunk past K10's budget: K9 per decoded
   frame and device, no K10), 0.6B on ``make_mesh(2, 2)`` at B=1 (K9 and K10
   on the first data row's ranks once per decoded frame), and 0.6B tp=2
   with ``spec_k=4`` whose acceptance floor trips after one iteration (the
   verify pass plain, the candidates' chains cached, then one K9 and one K10
   per sequential frame).  With two cards or more the kernel checks and the engines run again
   with the ranks on distinct cards; with one, a line says that run was not
   made.  K9 on a narrow one-slot ring (four rows a stage) equals the step
   on the default ring bit for bit: the only setting where a read of the o
   stage before its wait shows.
15. ``precision_phase``: the CLI's remaining weight-precision flags.  K1 at
   int4 units (real bits=4 packs: group-128 scales) against its plain
   version at the 0.6B widths (T=256 and 2560) and the 1.7B widths, on a
   bf16 cache under the deep limits and on an int8 cache, and on one layer
   (float32, bf16 and int8 caches: 24 inputs each, the one-layer limits and
   the tight count), timed in turns with int8 units and traced; K2 on the
   0.6B int4 trunk with int8 heads, on the int8 trunk with bf16 heads and on
   the int4 trunk with bf16 heads, greedy and sampled, against its plain
   version, and K3 equal to K2 on a float32 cache bit for bit; K3 at the
   1.7B widths on the int4 trunk (int8 heads) and on the int8 trunk with
   bf16 heads (K5's flip rule), and equal to K2 on a float32 cache; K6 at
   bf16 units (1 x 4, 4 x 8) against its plain version with its rows the K1
   bf16 steps bit for bit, on bf16 and int8 caches (slot writes stalled too),
   on one layer with the tight count; every new instance equal to itself bit
   for bit on a one-slot ring and on a narrow one (four rows a stage).  Then
   the batched kernels at the same units: K4 and K6 at int4 units (0.6B,
   deep and one-layer limits, bf16, float32 and int8 caches) with K4 rows
   equal to K1 int4 and K6 rows to the int4 steps bit for bit, K5 on the
   int4 trunk with int8 heads and on int8 and int4 trunks with bf16 heads
   (K5's flip rule) with its rows equal to K2 bit for bit, each on a
   one-slot and a narrow ring.  Then the CLI from a 0.6B checkpoint under
   --quantize int4 (with and without --kv-quant), --mtp-quantize int8 and
   auto, --spec-k 4 (also with --kv-quant, with --quantize int4 --kv-quant
   and with --mtp-quantize int8), --frame-fused on at --quantize int4 and
   at --mtp-quantize int8 (one K7 per frame), each a valid WAV with its
   ms/frame and launch counts; short 1.7B
   requests, batches and pools at --quantize int4 and at --mtp-quantize
   int8; 0.6B batches and pools at --quantize int4 and at --mtp-quantize
   int8 / auto (greedy pool output equal to B=1), a batch of 48 at
   --quantize int4 (two launches of 24 rows a kernel) with every stream
   equal to the batch in launches of at most 8 rows, a B=32 batch at
   --quantize int8 --mtp-quantize auto (K5 on the int4 alt trunk); fails
   if a new instance never launched on those paths.
16. ``finish_phase``: K7 at every unit mix the engine builds (int4 units,
   an int8 talker beside an int4 trunk and the reverse, a bf16 talker with
   bf16 lm_head and heads beside an int8 or an int4 trunk) against the
   composition K2 -> float32 x -> K1 -> norm+lm_head of the same mix bit
   for bit (bf16 cache at T=256 and 2560, float32 and int8 caches, a
   one-slot and a narrow ring) and against its plain version (timed beside
   the composition); 0.6B ``frame_fused=True`` engines at each mix's flags,
   with and without ``kv_quant`` (one K7 per decoded frame); K4, K5 and K6
   at 40 and 64 rows (two launches each) equal bit for bit to calls of at
   most 32 rows, timed beside one launch.  Besides: main's int8 engines
   decode a batch of 40 (every stream equal to the batch in launches of at
   most 8 rows), a pool of 40 slots and a spec pool of 12 x 4 (greedy
   requests equal to B=1); ``bf16_17b`` a 1.7B bf16 batch of 34 (two
   launches of 17 rows on the 48 KB plans) equal to the batch in launches
   of at most 8.
17. ``train_phase``: the training path at the 0.6B preset's full depth
   (28 talker layers, 6 MTP layers; random bf16 weights from the seed,
   ``init_params`` on the card).  ``tts_loss`` at step 0 on a batch of 4
   rows (16 text tokens, 120 frames, 60-119 of them real) against the same
   function on a float32 copy of the params (the loss within
   TRAIN_LOSS_REL, the gradients of lm_head, layer 0's wq, the MTP heads and
   text_embed within TRAIN_GRAD_COS by cosine); with the talker's
   ``attn_impl="pallas"`` the loss is refused under grad and, under
   ``torch.no_grad()``, within K8_LOSS_REL of the xla loss with one K8
   launch per talker layer; ten ``make_train_step`` steps (AdamW, clip 1.0)
   with the loss finite and falling: ms per step, frames per second, peak
   memory.  K8 at the draft teacher's shape (B=8, S = T = 136, padded
   frames masked as keys) against its plain version, timed beside SDPA;
   twenty ``make_draft_train_step`` steps (d_model 512) with the teacher
   pass on K8 (28 launches a pass) and the loss falling.  Then
   ``tools.train_draft`` on a 0.6B checkpoint of the seed's weights,
   written before the steps (``--frames 32 --temperatures 0.0 --steps
   20``; rollouts through the
   engine at bf16 units, one K1 and one K3 a frame): rc 0, the loss
   falling; a ``spec_k=4`` engine on the checkpoint it wrote drafts with
   the trained head and decodes the sequential engine's greedy codes.
18. ``routes_phase``: the JAX package's routes outside its step and chain
   kernels at the 0.6B widths.  K1 and K4 at the MTP trunk inside the
   per-step chain (B=1 and 4, greedy), every step against the plain version
   on a copy of its caches, at 6 layers (K1's deep limits) and one layer
   (the one-layer limits and tight share); a shared-head checkpoint saved
   and loaded (one K1 per chain position) and a pool of one slot on it (K4
   at one row); the iSTFT vocoder at the
   preset's widths, chunked at its left context against whole decoding and
   the card against the CPU; K8 at head_dims 17-256 and 1-32 q heads per kv
   head against its plain version (K8_BF16_REL, K8_BF16_FLIPS), timed
   beside SDPA, and on a main path (a talker of head_dim 80 and 32 q heads
   per kv head, its depth cut to REACH_LAYERS); the plain attention's
   memory at B=32, T=2560.  Beside the build (``beside_build``, while
   phase 2's compilers run on a thread): the plain talker (``decode_impl=
   "xla"``) with the cached and with the dense chain (B=1,
   ``synthesize_batch`` B=4, a pool of 2, spec_k=4; no kernel launched),
   after the profiler's one-time set-up, and the meshes' plain routes
   (``mesh_plain_runs``, 0.6B, MESH_FRAMES frames a request, no kernel
   launched, the data group of each request logged): the witnesses on
   ``make_mesh(1, 1)`` (B=1, a pool and a spec pool (spec_k=4) of one
   slot), then ``synthesize_batch`` of 2 on ``make_mesh(2, 1)`` and on
   ``make_mesh(2, 2)`` a pool of 2 with 3 requests, a spec pool of 2 with 2
   and a ``BatchingServer`` with 2, one row or slot a data group, each
   request's greedy codes equal to its witness's), and one
   data-parallel train step on ``make_mesh(2, 1)`` (this card listed twice:
   phase 17's batch over two groups) on float32 copies of the params against
   the one-device step on the same batch: the loss and the updated lm_head
   within TRAIN_LOSS_REL; its ms per step and peak memory.  Before it, in phase 6's engines,
   the 0.6B preset at ``mtp_resident=False`` (B=1, ``synthesize_batch``
   B=8, spec k=4: one K1 or K4 per chain position, no chain kernel; spec's
   greedy codes equal to the same engine's sequential decode), and in
   phase 11
   the 1.7B engine with ``QTTS_MTP_STREAM=0`` (the per-step chain).  Every
   phase before this one runs with ``QTTS_ASSERT_FUSED=1``.
19. ``tools_phase``: the report tools (``leaxer_qwen3_tts_torch/tools``).
   ``parity_check.gate_fixture`` holds 0.6B engines at int8 units and at
   bf16 units, built on the JAX tools' random fill (``quality_report.
   _random_engine_inputs``, bit for bit the JAX package's), against the
   fixtures the JAX tools wrote from the same weights on the CPU
   (tests/fixtures/parity_0p6b_int8.npz and _bf16.npz, 8 frames of "hello
   world"): token ids equal; prompt embeds, prefill logits and, over the
   frames before the codes first part, decode logits and waveform within
   the JAX tool's absolute bounds and ``parity_check.REL_BOUNDS`` (L-inf
   over the reference's largest value), the logits' correlation at least
   0.999; the codes' agreement and first part printed as data, a first part
   at code0 explained by a near tie; one K1 and one K2 (int8) or K3 (bf16
   units) per decoded frame.  Then ``quality_report`` (int8 against bf16
   units) and ``spec_report`` (k=4, one text, bf16 units) through their
   ``main`` at REPORT_FRAMES frames: exit 0 with their JSON line, greedy spec
   equal to sequential.  Beside the build (no kernel) run the engines of
   phases 6-9 and of this phase, phase 18's shared-head engine through save
   and load, and phase 10's checkpoint save and load (``main_engines``,
   ``parity_engines``, ``shared_head_engine``, ``entry_checkpoint``).
20. The kernel report (each kernel's launches on the main paths, error
   against its plain version, time, plain time, least-time bound and, for
   K8, the library call's time; K1, K3, K4 and K5 once more for bf16 units;
   K1, K4, K6 and K7 once more for the int8 KV cache; K9 per step, K10 per
   chain; K1 int4, K2 / K3 int4 and mixed heads, K6 bf16; K4 / K6 int4,
   K5 int4 and mixed heads, K4 / K5 / K6 bf16 at 1.7B; K7 at each unit
   mix, on a bf16 and an int8 cache; K8 at the draft teacher's shape; K1
   and K4 at the MTP trunk in the per-step chain; K8 at the head_dims and
   groups the presets do not use) and the device line; it fails if any
   kernel in it never launched.  The last log line gives the build's
   seconds, the seconds after it and what they would be on the slowest host
   seen (a 588.8 s build, every phase 1.235x longer).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import queue
import random
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

import numpy as np
import torch

from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.cli.main import main as cli_main
from leaxer_qwen3_tts_torch.config import (
    CODEC_EOS,
    LANG_ENGLISH,
    PRESET_SPEAKERS,
    QWEN3_TTS_06B,
    QWEN3_TTS_17B,
    SAMPLES_PER_FRAME,
    DraftConfig,
)
from leaxer_qwen3_tts_torch.frontend import Tokenizer, write_wav
from leaxer_qwen3_tts_torch.frontend._bpe_py import byte_to_proxy
from leaxer_qwen3_tts_torch.models.code_predictor import chain_kernel, chain_pack, chain_route
from leaxer_qwen3_tts_torch.models.codec12hz import vocoder_forward
from leaxer_qwen3_tts_torch.models import draft as draft_module
from leaxer_qwen3_tts_torch.models.draft import init_draft_params
from leaxer_qwen3_tts_torch.models.layers import init_transformer_params, quantize_kv
from leaxer_qwen3_tts_torch.ops import _build
from leaxer_qwen3_tts_torch.ops import flash_attention as K8
from leaxer_qwen3_tts_torch.ops import fused_frame as K7
from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as K3
from leaxer_qwen3_tts_torch.ops import fused_step as K1
from leaxer_qwen3_tts_torch.ops import fused_verify as K6
from leaxer_qwen3_tts_torch.ops import fused_mtp_tp as K10
from leaxer_qwen3_tts_torch.ops import fused_tp as K9
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params, quantize_weight
from leaxer_qwen3_tts_torch.runtime.prompt import prompt_length
from leaxer_qwen3_tts_torch.runtime.sampling import (
    SamplingParams,
    gumbel_noise,
    make_codec_suppress_mask,
    scale_by_temperature,
)
from leaxer_qwen3_tts_torch.runtime.speculative import (
    make_replay_draft,
    make_spec_generate_fns,
    repeat_draft,
)
from leaxer_qwen3_tts_torch.runtime.weights import (
    flatten_params,
    init_params,
    load_checkpoint,
    param_count,
    save_checkpoint,
)
from leaxer_qwen3_tts_torch.parallel import make_mesh, split_rows
from leaxer_qwen3_tts_torch.serve import BatchingServer, ContinuousBatcher, make_http_server
from leaxer_qwen3_tts_torch.tools import a8_probe as P1
from leaxer_qwen3_tts_torch.tools import parity_check, quality_report, spec_report, unit_probe
from leaxer_qwen3_tts_torch.tools import w8a8_probe as P2
from leaxer_qwen3_tts_torch.tools.train_draft import main as train_draft_main
from leaxer_qwen3_tts_torch.training import (
    LossMetrics,
    init_train_state,
    make_optimizer,
    make_train_step,
    shard_train_state,
    tts_loss,
)
from leaxer_qwen3_tts_torch.training.draft_loss import draft_loss, make_draft_train_step
from leaxer_qwen3_tts_torch.training.train_step import adam, param_leaves

DEV = torch.device("cuda")
SEED = 0
# Kernel vs plain tolerances.  Both sides round the same operands to bf16
# and accumulate in float32 in different orders; a ~1e-7 difference flips
# the bf16 rounding of a few activations and bf16 cache entries (one ulp:
# 0.0078 at magnitude 1), and over 28 random-weight layers the flips compound:
# the plain version moves by ~1e-2 relative (x) under a 2^-20 relative
# change of its own input (measured on an H100; printed beside each check
# as `plain_sensitivity`), so the deep bf16 checks are held to 5e-2.  On one
# layer nothing cascades: most inputs agree to ~1e-7, and when a GEMV input
# lands on a bf16 rounding edge the flip moves x by up to 1.8e-3 relative and
# the written slot by up to 2.2e-3 relative (288 seeded inputs, H100).  A wrong
# index, sign or scale moves them by O(1).  Those flip-tolerant limits cannot
# see a small systematic fault (one attention slot dropped or counted twice, a
# bf16-rounded residual: 2e-3 to 5e-3 relative), so each shallow case also
# runs K1_TIGHT_INPUTS seeded inputs and needs K1_TIGHT_MIN of them to agree
# to K1_TIGHT_REL in x and in the written slot.  A flip hits some inputs: on
# an H100 16 to 23 of 24 agreed, for both cache dtypes at every position.  A
# systematic fault hits every input: each of those three faults, built into
# a copy of fused_step.cu, left 0 of 24 tight wherever it applies.
K1_DEEP_X_REL, K1_DEEP_SLOT_ABS = 5e-2, 1.25e-1  # max|dx|/max|x|; slot abs
K1_SHALLOW_X_REL, K1_SHALLOW_SLOT_ABS = 1e-2, 2.5e-2
K1_SHALLOW_LAYERS = 1
# every ladder bucket, the attention's 64-slot split edges and the first slot
K1_SHALLOW_CASES = ((2560, 1800), (256, 0), (256, 63), (512, 64), (1024, 1023), (2560, 2559))
K1_TIGHT_REL = 1e-5
K1_TIGHT_INPUTS, K1_TIGHT_MIN = 24, 8
K2_MARGIN_REL = 1e-5  # a sub-code mismatch passes only below this score margin
K2_SUM_ABS = 1e-5  # sub_sum when every sub-code matches (same table rows)
# K4 per-row positions: the first slot, both sides of a 64-slot split edge,
# one past a 512-slot bucket (clamped to the last slot), the last slot, others
K4_POSITIONS = (0, 63, 64, 700, 511, 5, 200, 130)
K4_SHALLOW_BATCHES = (2, 8, 32)
# K5 per-row knobs: greedy; the engine defaults; top-k and top-p off; top_k = 1
K5_KNOBS = ((0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 1.0), (0.7, 1, 0.9))
# K5 against its plain version: every row of K5 equals K2 on it bit for bit
# (checked), so what remains is K2's rounding against the plain chain.  Each
# trunk pass runs 6 layers with a bf16 cache, where rounding flips move the
# kernel's x from the plain version's by up to ~4e-3 relative (the K4
# MTP-trunk check above; 3.7e-3 on an H100), so over 8-32 rows x 15 steps a
# sub-code may flip where two scores lie that close, or where a token sits
# that close to the top-k or top-p cut (then its score margin is not small).
# So a row's first mismatch passes if the plain sampler picks the kernel's
# token on the same noise from the plain logits scaled elementwise by
# (1 + eps * N(0, 1)) for some eps in K5_FLIP_EPS (16 draws each), and at
# least K5_MIN_EQUAL of the rows must match in full.  A wrong row, knob or
# noise row picks an unrelated token in most rows.
K5_FLIP_EPS = (1e-5, 1e-4, 1e-3, 3e-3, 1e-2)
K5_MIN_EQUAL = 0.5
# K6 (B, S, T, starts, timing iterations) at full depth: S=4 at B=1 in two
# buckets, 8 streams x 3 candidates (the timed shape of a spec pool), and 4 x 8
# rows with starts across a 64-slot split edge and at T - S of the bucket
K6_DEEP_CASES = ((1, 4, 256, [200], 20), (1, 4, 512, [300], 20),
                 (8, 3, 512, [0, 62, 63, 64, 509, 700, 130, 5], 10),
                 (4, 8, 512, [60, 5, 504, 200], 5))
# K6 (B, S, starts) on one layer at T=512, under the K1 limits and tight share:
# the first slot, rows across a split edge, the last start of the bucket,
# and one start past it (clamped to T - S)
K6_SHALLOW_CASES = ((1, 2, [0]), (1, 4, [62]), (1, 8, [504]), (4, 4, [0, 61, 200, 600]),
                    (4, 8, [62, 5, 504, 130]))
# K6 with every slot write stalled K6_STALL_NS first (check_k6_equal), at
# full depth, starts at a split edge so that readers of the new slots open
# their split with them: the slot-write phase's grid barrier must hold them
K6_STALL_CASES = ((1, 4, 256, [192]), (4, 8, 512, [64, 5, 504, 128]))
K6_STALL_NS = 20_000
# The 1.7B phase: a VoiceDesign request (the instruction makes the longest
# prefill the system builds) and a CustomVoice preset speaker
VOICE_TEXT = "hello world, this voice was designed by an instruction"
VOICE_INSTRUCT = "a warm and low voice, speaking slowly and clearly"
# K1 at the 1.7B widths on one layer: a bucket's first split edge and the
# last slot of the 1024 bucket, float32 and bf16 caches
K1_17B_SHALLOW_CASES = ((256, 63), (1024, 1023))
STREAM_OFF_FRAMES = 12  # the 1.7B per-step chain's request (QTTS_MTP_STREAM=0)
# K3 runs K2's arithmetic with a float32 cache, so on the same inputs the two
# agree bit for bit; a K3-only fault does not: a bf16 scratch moves the 6-layer
# trunk's x by ~1e-2 relative and flips a near-tie sub-code in a few percent
# of the steps, so over 16 chains x 15 steps it cannot hide
K3_EQUAL_INPUTS = 16
# K8 against its plain version.  float32: the same online softmax (32-key
# tiles in the kernel, the JAX kernel's 128 in the plain version) and dot
# products summed in another order, ~1e-6 relative on outputs below ~4 in
# magnitude; a dropped key tile or a mis-masked key moves them by ~1e-1.
# bf16 outputs: at most one bf16 ulp, 2^-7 of the largest output.
K8_F32_ABS = 2e-5
K8_BF16_REL = 2 ** -7
# ... and at most this share of the bf16 outputs differs from the plain
# version's bf16 value at all.  The tensor-core kernel's P is bf16 hi + lo,
# within 2^-17 of P, and its scores and sums are float32 in another order:
# each output moves by ~2^-16 relative or less, so it crosses a bf16
# rounding edge (an ulp is 2^-8 to 2^-7 relative) for at most ~2^-8 of the
# outputs.  P rounded once to bf16 moves each output by ~2^-10 relative and
# changes ~1/8 of them.
K8_BF16_FLIPS = 2 ** -6
# (B, S, T, nq, nk) with queries at T-S..T-1, per-batch invalid keys and
# batch 0's first row masked everywhere: ragged S and T (none a multiple of
# a key tile), GQA 2:1 to 8:1 and MHA, S = 1
K8_RANDOM_SHAPES = ((2, 37, 301, 16, 8), (1, 5, 23, 8, 2), (3, 17, 130, 16, 2), (2, 1, 200, 4, 4))
# the key range's edges, (B, S, T, nq, nk, kind): "dead rows", batch 0 with
# rows masked everywhere beside rows that are not; "last tile", every
# allowed key in the last 64-key tile
K8_SCHEDULE_CASES = ((2, 9, 150, 16, 2, "dead rows"), (2, 37, 301, 16, 8, "dead rows"),
                     (1, 57, 256, 16, 8, "last tile"), (2, 9, 150, 4, 4, "last tile"),
                     (1, 1, 150, 8, 1, "last tile"))
# K8's reach (B, S, T, nq, nk, d, kind): every head_dim the presets do not
# use (64, 80 and 96 zero-padded to 128 in the kernel's tiles, 256, and two
# that are no multiple of 8: 100, copied value by value, and the odd 17) and
# every q-per-kv group 1..32 (32: a kv head's q heads over two blocks)
K8_REACH_CASES = ((1, 57, 256, 16, 8, 64, "prefill"), (2, 17, 130, 8, 8, 80, "random"),
                  (1, 33, 200, 16, 4, 96, "dead rows"), (1, 57, 256, 16, 2, 128, "prefill"),
                  (1, 40, 256, 16, 1, 256, "random"), (2, 9, 150, 32, 1, 128, "dead rows"),
                  (1, 21, 100, 64, 2, 64, "random"), (1, 13, 90, 6, 2, 100, "random"),
                  (1, 7, 40, 4, 2, 17, "last tile"))
# K7 (the whole frame) at the 0.6B widths, (T, pos): the first slot past a
# 64-slot split edge and the last slot, in the first bucket and in the 2560
# bucket; greedy and two sampled knob sets; K7_INPUTS seeded inputs each (EOS
# forbidden in every other one, and on top of the logits in half of them).
# K7 runs K2's chain, K1's step and K1's GEMV body on the final norm with the
# same thread counts and reduction orders, so on the same inputs it equals
# the composition K2 -> float32 next input -> K1 -> qtts_norm_head bit for
# bit; against its plain version it takes K1's deep limits and K5's flip rule.
K7_CASES = ((256, 64), (256, 255), (2560, 1792), (2560, 2559))
K7_KNOBS = ((0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 1.0))
K7_INPUTS = 16
FIXED_TEXT = "hello world, this is a fixed length run"
# frames of every fixed run: the fewest that cross from the 256 bucket into
# 512 without an instruction (cut from 300 to keep the smoke inside its
# time limit)
FIXED_FRAMES = 248
# The persistent K1 and K2 against the launch-per-op sequences they replaced
# (qtts_decode_step_multi, qtts_mtp_chain_multi): the same operations in the
# same order, so x, both caches, the sub-codes and sub_sum equal bit for bit.
# K1 at the first slot, a 64-slot split edge and inside and at the end of
# the 256 and 2560 buckets, both cache dtypes; K2 on K5_KNOBS (greedy and
# three sampled knob sets), both cache dtypes.
K1_EQUAL_CASES = ((256, 0), (256, 63), (256, 200), (2560, 64), (2560, 1800), (2560, 2559))
K1_EQUAL_INPUTS = 2
K2_EQUAL_INPUTS = 16
# The persistent K4 and K5 against K1 / K2 row by row and against the
# launch-per-op sequences they replaced (qtts_decode_step_batched_multi,
# qtts_mtp_chain_batched_multi), bit for bit.  K4 (B, T) at the 0.6B talker,
# both cache dtypes, rows at the first slot, both sides of a split edge, the
# last slot, one past the bucket (clamped) and inside; K5 at B rows on
# K5_KNOBS cycled over the rows, both cache dtypes.
K4_EQUAL_CASES = ((2, 256), (5, 256), (8, 256), (32, 256), (2, 2560), (5, 2560), (8, 2560),
                  (32, 2560))
K5_EQUAL_BATCHES = (2, 8, 32)


CARD = "card not read yet"  # the nvidia-smi line, printed beside every measured number


STARTED = time.perf_counter()


def log(msg: str) -> None:
    """A line of the report, after the seconds since the script started."""
    print(f"[{time.perf_counter() - STARTED:7.1f} s] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# Least-time bounds: the bytes a call must move (each input read once, each
# output written once) over the memory rate, and its operations over the
# bf16 tensor rate, of an H100 SXM at 700 W (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


# float32 multiply-adds on CUDA cores: 67 TFLOPS (H100 SXM data sheet) /
# 2.  K4 and K5 keep K1's and K2's summation order, which a tensor-core mma
# would not, so at B=32 this floor, not the bytes, is theirs.
FP32_FMA_PER_S = 67e12 / 2


def fma_floor_ms(macs: float, rows: int) -> float:
    """Least ms of ``rows`` x ``macs`` float32 multiply-adds on CUDA cores."""
    return rows * macs / FP32_FMA_PER_S * 1e3


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations")."""
    ms_bytes, ms_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def slot_bytes(t, cache_dtype) -> int:
    """Bytes of one cache slot over every layer: k and v of each kv head in
    the cache dtype, and an int8 cache's two float32 scales per head."""
    elem = torch.empty((), dtype=cache_dtype).element_size()
    scales = 2 * 4 if cache_dtype == torch.int8 else 0
    return t.num_layers * t.num_kv_heads * (2 * t.head_dim * elem + scales)


def weights(fw) -> int:
    """The weights of a pack's four products (an int4 byte holds two)."""
    per = 2 if fw.wqkv.dtype == torch.uint8 else 1
    return per * sum(w.numel() for w in (fw.wqkv, fw.wo, fw.wgu, fw.wd))


def step_bound(t, fw, rows: int, ctx, S: int, cache_dtype):
    """Bound of one step (S = 1: K1, K4) or verify pass (K6) of ``rows`` rows,
    S per stream, stream b reading its ``ctx[b]`` cached slots: the packed
    weights, those slots, the S new slots per stream and x in and out; the
    GEMV products and each row's attention over its slots."""
    L, nk, nq, d, H = t.num_layers, t.num_kv_heads, t.num_heads, t.head_dim, t.hidden_size
    slot = slot_bytes(t, cache_dtype)
    moved = nbytes(fw) + slot * (sum(ctx) + rows) + 2 * rows * H * 4
    macs = weights(fw)
    attn = sum(c + s + 1 for c in ctx for s in range(S))  # slots each row attends to
    return bound(moved, 2 * rows * macs + 4 * L * nq * d * attn)


def chain_bound(t, fw, heads, rows: int):
    """Bound of one MTP chain of ``rows`` rows (K2, K5): the trunk and the
    heads read once, each row's 15 table rows, sub-codes and sum written; 16
    trunk passes and 15 head products per row."""
    n, V, H = heads.q.shape
    moved = nbytes(fw) + nbytes(heads) + rows * (n * H * 2 + 2 * H * 4 + H * 4 + n * 4)
    macs = weights(fw)
    attn = t.num_layers * 4 * t.num_heads * t.head_dim * sum(range(1, n + 2))
    return bound(moved, 2 * rows * ((n + 1) * macs + n * V * H) + rows * attn)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_call(fn):
    """(``fn()``, its milliseconds by CUDA events): one call, timed where a
    check makes it anyway, so that a slow plain version runs once."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn`` from ``torch.profiler``: the
    self device time of every device op over ``iters`` calls (after one
    warm-up), without the host's time between launches; NaN (not measured)
    where the profiler recorded no device time at all, as it did for K8's
    teacher-shape check late in a whole smoke run on an H100."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / 1e3 / iters if total > 0 else float("nan")


def packed_trunk(t, gen):
    layers = quantize_params(fuse_params({"m": {"transformer": init_transformer_params(
        t, gen, DEV)}}, modules=("m",)), modules=("m",))["m"]["transformer"]["layers"]
    return K1.pack_fused_weights(t, layers)


@dataclasses.dataclass
class K1Run:
    """One seeded input through K1 and its plain version."""

    x: torch.Tensor
    kc: torch.Tensor  # caches before the step
    vc: torch.Tensor
    xp: torch.Tensor  # the plain version's x
    err: float  # max |x_kernel - x_plain|
    rel: float  # err / max |x_plain|
    slot_err: float  # max abs error of the k and v written at pos
    slot_rel: float  # slot_err / max |written slot, plain|
    untouched: bool  # the kernel left every other slot as it was


def k1_multi(t, fw, x, pos, kc, vc):
    """K1's launch-per-op sequence (``qtts_decode_step_multi``, six launches
    per layer) on the same inputs: the reference the persistent K1 is held
    to bit for bit.  Returns x_out [1, H]; the caches are updated in place."""
    T = kc.shape[3]
    w, s, scratch = K1.step_structs(t, fw, T, DEV)
    x_in = x.float().reshape(-1).contiguous()
    out = torch.empty((1, t.hidden_size), dtype=torch.float32, device=DEV)
    err = _build.load_kernels().qtts_decode_step_multi(
        w, s, x_in.data_ptr(), out.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        int(kc.dtype == torch.bfloat16), T, min(int(pos), T - 1),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "qtts_decode_step_multi")
    del scratch  # enqueued; the caching allocator orders reuse on the stream
    return out


def k2_multi(t, fw, fnorm, heads, tables, lh, c0, noise, temperature, top_k, top_p,
             cache_dtype=torch.float32):
    """K2's launch-per-op chain (``qtts_mtp_chain_multi``: K1's layer launches
    per trunk pass, one head + sampler kernel per step) on the same inputs:
    the reference the persistent K2 is held to bit for bit."""
    return K2._launch_chain(k2_multi, "qtts_mtp_chain_multi", t, fw, fnorm, heads, tables, lh,
                            c0, noise, temperature, top_k, top_p, cache_dtype)


k2_multi.launches = 0  # not a kernel of the path: compare-only launches


def k3_multi(t, fw, fnorm, heads, tables, lh, c0, noise, temperature, top_k, top_p):
    """K3's launch-per-op chain (``qtts_mtp_chain_streamed_multi``: K2's
    launch-per-op chain on a float32 cache) on the same inputs: the
    reference the persistent K3 is held to bit for bit."""
    return K2._launch_chain(k3_multi, "qtts_mtp_chain_streamed_multi", t, fw, fnorm, heads,
                            tables, lh, c0, noise, temperature, top_k, top_p, torch.float32)


k3_multi.launches = 0  # not a kernel of the path: compare-only launches


def k1_run(t, fw, T, pos, cache_dtype, gen) -> K1Run:
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    kk, vk = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    xk, _, _ = K1.fused_decode_step(t, fw, x, pos, kk, vk)
    xp, _, _ = K1.fused_decode_step_reference(t, fw, x, pos, kp, vp)
    torch.cuda.synchronize()
    err = float((xk - xp).abs().max())
    slot_k = torch.stack((kk[:, :, :, pos], vk[:, :, :, pos])).float()
    slot_p = torch.stack((kp[:, :, :, pos], vp[:, :, :, pos])).float()
    slot_err = float((slot_k - slot_p).abs().max())
    others = torch.ones(T, dtype=torch.bool, device=DEV)
    others[pos] = False
    untouched = bool(torch.equal(kk[:, :, :, others], kc[:, :, :, others])) and bool(
        torch.equal(vk[:, :, :, others], vc[:, :, :, others]))
    return K1Run(x, kc, vc, xp, err, err / float(xp.abs().max()), slot_err,
                 slot_err / float(slot_p.abs().max()), untouched)


def time_k1(t, fw, r: K1Run, pos, iters):
    """Kernel and plain ms per step on the run's input and caches."""
    kk, vk, kp, vp = r.kc.clone(), r.vc.clone(), r.kc.clone(), r.vc.clone()
    ms = time_ms(lambda: K1.fused_decode_step(t, fw, r.x, pos, kk, vk), iters)
    plain_ms = time_ms(lambda: K1.fused_decode_step_reference(t, fw, r.x, pos, kp, vp), 3, 1)
    return ms, plain_ms


def check_k1_deep(name, t, fw, T, pos, gen, iters):
    """One input at full depth with a bf16 cache, held to the deep limits."""
    r = k1_run(t, fw, T, pos, torch.bfloat16, gen)
    # elementwise (a uniform scale would vanish in the first RMSNorm)
    wiggle = 1 + 2 ** -20 * torch.randn(r.x.shape, generator=gen, device=DEV)
    xs, _, _ = K1.fused_decode_step_reference(t, fw, r.x * wiggle, pos, r.kc.clone(),
                                              r.vc.clone())
    sensitivity = float((xs - r.xp).abs().max()) / float(r.xp.abs().max())
    ms, plain_ms = time_k1(t, fw, r, pos, iters)
    ok = r.rel < K1_DEEP_X_REL and r.slot_err < K1_DEEP_SLOT_ABS and r.untouched
    log(f"K1 {name}: L={t.num_layers} T={T} pos={pos} cache=bfloat16 x max_abs_err="
        f"{r.err:.3e} rel={r.rel:.3e} (tol {K1_DEEP_X_REL}; plain_sensitivity "
        f"{sensitivity:.3e}) slot max_abs_err={r.slot_err:.3e} (tol {K1_DEEP_SLOT_ABS}) "
        f"untouched_slots_equal={r.untouched} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"-> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K1 {name} disagrees with its plain version")
    return r.err, ms, plain_ms


def check_k1_shallow(name, t, fw, T, pos, cache_dtype, gen, iters):
    """K1_TIGHT_INPUTS seeded inputs on a shallow trunk: every one within the
    flip-tolerant limits, and at least K1_TIGHT_MIN of them tight."""
    runs = [k1_run(t, fw, T, pos, cache_dtype, gen) for _ in range(K1_TIGHT_INPUTS)]
    rel = max(r.rel for r in runs)
    slot_err = max(r.slot_err for r in runs)
    untouched = all(r.untouched for r in runs)
    tight = sum(r.rel <= K1_TIGHT_REL and r.slot_rel <= K1_TIGHT_REL for r in runs)
    ms = plain_ms = float("nan")
    if iters:
        ms, plain_ms = time_k1(t, fw, runs[0], pos, iters)
    ok = (rel < K1_SHALLOW_X_REL and slot_err < K1_SHALLOW_SLOT_ABS and untouched
          and tight >= K1_TIGHT_MIN)
    log(f"K1 {name}: L={t.num_layers} T={T} pos={pos} cache={str(cache_dtype)[6:]} "
        f"{len(runs)} inputs: x max rel {rel:.3e} (tol {K1_SHALLOW_X_REL}) slot "
        f"max_abs_err={slot_err:.3e} (tol {K1_SHALLOW_SLOT_ABS}) tight (x and slot rel <= "
        f"{K1_TIGHT_REL}) {tight}/{len(runs)} (need {K1_TIGHT_MIN}) "
        f"untouched_slots_equal={untouched} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"-> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K1 {name} T={T} pos={pos} disagrees with its plain version")
    return max(r.err for r in runs), ms, plain_ms


def k1_inputs(t, T, pos, cache_dtype, gen):
    """A seeded step input: x [1, H] and caches with the slots from pos on zeroed."""
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    return x, kc, vc


def check_k1_equal(name, t, fw, cases, gen, inputs=K1_EQUAL_INPUTS):
    """The persistent K1 against K1's launch-per-op sequence on ``inputs``
    seeded inputs per (T, pos) of ``cases`` and cache dtype: x and both
    caches equal bit for bit.  Returns the number of steps compared."""
    equal = total = 0
    for T, pos in cases:
        for cache_dtype in (torch.bfloat16, torch.float32):
            for _ in range(inputs):
                x, kc, vc = k1_inputs(t, T, pos, cache_dtype, gen)
                kn, vn, ko, vo = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                xn, _, _ = K1.fused_decode_step(t, fw, x, pos, kn, vn)
                xo = k1_multi(t, fw, x, pos, ko, vo)
                same = bool(torch.equal(xn, xo)) and bool(torch.equal(kn, ko)) and bool(
                    torch.equal(vn, vo))
                if not same:
                    log(f"K1 {name} T={T} pos={pos} cache={str(cache_dtype)[6:]}: the persistent "
                        f"step differs from the launch sequence (x max diff "
                        f"{float((xn - xo).abs().max()):.3e})")
                equal += same
                total += 1
    ok = equal == total
    log(f"K1 persistent vs launch sequence, {name}: L={t.num_layers} (T, pos) {list(cases)} x "
        f"bf16/f32 caches x {inputs} inputs: {equal}/{total} steps equal bit for bit (x, k and v "
        f"caches) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"the persistent K1 differs from the launch sequence ({name})")
    return total


def check_k2_equal(label, cp, fw, heads, tables, fnorm, gen, inputs=K2_EQUAL_INPUTS,
                   cache_dtypes=(torch.bfloat16, torch.float32)):
    """The persistent K2 against K2's launch-per-op chain on ``inputs``
    seeded inputs per knob set of K5_KNOBS and cache dtype: sub-codes and
    sub_sum equal bit for bit.  Returns the number of chains compared."""
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    t = cp.transformer
    equal = total = 0
    for cache_dtype in cache_dtypes:
        for knobs in K5_KNOBS:
            sp = SamplingParams.create(*knobs)
            for i in range(inputs):
                lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
                c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
                noise = None if sp.greedy else gumbel_noise((n, 1, V), gen, DEV)
                args = (t, fw, fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k,
                        sp.top_p)
                sn, sum_n = K2.fused_mtp_chain(*args, cache_dtype=cache_dtype)
                so, sum_o = k2_multi(*args, cache_dtype=cache_dtype)
                same = bool(torch.equal(sn, so)) and bool(torch.equal(sum_n, sum_o))
                if not same:
                    log(f"{label} knobs {knobs} cache={str(cache_dtype)[6:]} input {i}: persistent "
                        f"{sn[0].tolist()} vs launch sequence {so[0].tolist()}")
                equal += same
                total += 1
    ok = equal == total
    log(f"K2 persistent vs launch-per-op chain, {label}: knobs {K5_KNOBS} x caches "
        f"{[str(d)[6:] for d in cache_dtypes]} x {inputs} inputs: {equal}/{total} chains equal "
        f"bit for bit (sub-codes, sub_sum) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"the persistent K2 differs from the launch-per-op chain ({label})")
    return total


def k4_equal_positions(B, T):
    """Per-row positions of the K4 equality checks (unclamped)."""
    base = (0, 63, 64, T - 1, T + 100, 5, 200 % T, 130 % T)
    return [base[b % len(base)] for b in range(B)]


def k4_multi(t, fw, x, pos, kc, vc):
    """K4's launch-per-op sequence (``qtts_decode_step_batched_multi``, nine
    launches per layer) on the same inputs: the reference the persistent K4
    is held to bit for bit.  Returns x_out [B, H]; the caches are updated in
    place."""
    return K1._launch_step_batched(k4_multi, "qtts_decode_step_batched_multi", t, fw, x, pos, kc,
                                   vc)[0]


k4_multi.launches = 0  # not a kernel of the path: compare-only launches


def k5_multi(t, fw, fnorm, heads, tables, lh, c0, noise, temperature, top_k, top_p,
             cache_dtype=torch.float32):
    """K5's launch-per-op chain (``qtts_mtp_chain_batched_multi``) on the
    same inputs: the reference the persistent K5 is held to bit for bit."""
    return K2._launch_chain_batched(k5_multi, "qtts_mtp_chain_batched_multi", t, fw, fnorm, heads,
                                    tables, lh, c0, noise, temperature, top_k, top_p, cache_dtype)


k5_multi.launches = 0  # not a kernel of the path: compare-only launches


def k6_multi(t, fw, x, pos, kc, vc):
    """K6's launch-per-op pass (``qtts_verify_step_multi``, ten launches per
    layer) on the same inputs: the reference the persistent K6 is held to bit
    for bit.  Returns x_out [B, S, H]; the caches are updated in place."""
    return K6.launch_verify(k6_multi, "qtts_verify_step_multi", t, fw, x, pos, kc, vc)[0]


k6_multi.launches = 0  # not a kernel of the path: compare-only launches


def p1_multi(arm, w, s, x0, steps=P1.S):
    """P1's chain on the group kernel it ran before the weight ring
    (``qtts_unit_probe``, probe 1; P2's kernel): the reference the ring
    kernel is held to bit for bit."""
    return unit_probe.launch(p1_multi, arm, 1, w, s, x0, steps)


p1_multi.launches = 0  # not a kernel of the path: compare-only launches


def p2_multi(arm, w, s, x, passes=P2.P):
    """P2's chain on the group kernel it ran before the weight ring
    (``qtts_unit_probe``, probe 2): the reference the ring kernel is held to
    bit for bit."""
    return unit_probe.launch(p2_multi, P2.KERNEL_ARM[arm], 2, w, s, x, passes)


p2_multi.launches = 0  # not a kernel of the path: compare-only launches

# The launch-per-op entries of the kernel library: count_entries routes each
# through a counter, and check_launches fails if a main path reached one.
MULTI_ENTRIES = ("qtts_decode_step_multi", "qtts_mtp_chain_multi",
                 "qtts_decode_step_batched_multi", "qtts_mtp_chain_batched_multi",
                 "qtts_verify_step_multi", "qtts_mtp_chain_streamed_multi",
                 "qtts_frame_step_multi")
ENTRY_CALLS = {}


def count_entries(lib, names=MULTI_ENTRIES + ("qtts_unit_probe", "qtts_unit_probe_ring")):
    """Route the library's entries ``names`` through a counter of calls
    (ENTRY_CALLS): every wrapper looks its entry up on this one library."""
    for name in names:
        fn = getattr(lib, name)

        def counted(*a, _fn=fn, _name=name):
            ENTRY_CALLS[_name] = ENTRY_CALLS.get(_name, 0) + 1
            return _fn(*a)

        setattr(lib, name, counted)


def check_k4_equal(name, t, fw, cases, gen, inputs=1,
                   cache_dtypes=(torch.bfloat16, torch.float32), multi=True):
    """The persistent K4 on ``inputs`` seeded batches per (B, T) of ``cases``
    and cache dtype (per-row device positions of k4_equal_positions, and one
    batch at a host position per case): x and both caches equal the
    launch-per-op sequence's bit for bit (``multi``: int8 packs, the
    sequence's only units), and every row equals K1 on that row (x and the
    row's caches).  Returns the number of steps compared."""
    equal = total = 0
    for B, T in cases:
        for cache_dtype in cache_dtypes:
            L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
            for i in range(inputs + 1):
                pos = k4_equal_positions(B, T)
                host = i == inputs  # every row at one host position
                if host:
                    pos = [min(64, T - 1)] * B
                x = torch.randn((B, t.hidden_size), generator=gen, device=DEV) * 0.3
                # made in the cache dtype and compared in place: four caches
                # of [28, 32, 8, 2560, 128] float32 are 38 GB
                kc = torch.randn((L, B, nk, T, d), generator=gen, device=DEV, dtype=cache_dtype)
                vc = torch.randn((L, B, nk, T, d), generator=gen, device=DEV, dtype=cache_dtype)
                for b, p in enumerate(pos):
                    kc[:, b, :, min(p, T - 1):] = 0
                    vc[:, b, :, min(p, T - 1):] = 0
                kn, vn = kc.clone(), vc.clone()
                arg = pos[0] if host else torch.tensor(pos, device=DEV)
                xn, _, _ = K1.fused_decode_step_batched(t, fw, x, arg, kn, vn)
                rows_k1 = True
                for b, p in enumerate(pos):
                    k1, v1 = kc[:, b : b + 1].clone(), vc[:, b : b + 1].clone()
                    x1, _, _ = K1.fused_decode_step(t, fw, x[b : b + 1], p, k1, v1)
                    rows_k1 &= bool(torch.equal(x1[0], xn[b])) and bool(
                        torch.equal(k1[:, 0], kn[:, b])) and bool(torch.equal(v1[:, 0], vn[:, b]))
                same = True
                if multi:
                    xo = k4_multi(t, fw, x, arg, kc, vc)  # the sequence on the original caches
                    same = bool(torch.equal(xn, xo)) and bool(torch.equal(kn, kc)) and bool(
                        torch.equal(vn, vc))
                if not (same and rows_k1):
                    log(f"K4 {name} B={B} T={T} cache={str(cache_dtype)[6:]} positions {pos}: "
                        f"equal to the launch sequence {same}, rows equal to K1 {rows_k1}")
                equal += same and rows_k1
                total += 1
                del kc, vc, kn, vn
    ok = equal == total
    log(f"K4 persistent vs K1 rows{' and the launch sequence' if multi else ''}, {name}: "
        f"L={t.num_layers} (B, T) "
        f"{list(cases)} x caches {[str(d)[6:] for d in cache_dtypes]} x {inputs} batches at "
        f"device positions + 1 at a host position: {equal}/{total} steps equal bit for bit (x, k "
        f"and v caches) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"the persistent K4 differs from K1 or the launch sequence ({name})")
    return total


def check_k5_equal(label, cp, fw, heads, tables, fnorm, gen, batches=K5_EQUAL_BATCHES, inputs=1,
                   cache_dtypes=(torch.bfloat16, torch.float32), multi=True, row_chain=None):
    """The persistent K5 on ``inputs`` seeded chains per B of ``batches`` and
    cache dtype, the rows' knobs cycling through K5_KNOBS: sub-codes and
    sub_sum equal the launch-per-op chain's bit for bit (``multi``: int8
    packs), and every row equals the B=1 chain on that row's inputs and
    noise: K2 on the same cache, or ``row_chain`` (K3 for bf16 units, whose
    K5 runs on K3's float32 cache).  Returns the chains compared."""
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    t = cp.transformer
    equal = total = 0
    for cache_dtype in cache_dtypes:
        for B in batches:
            for i in range(inputs):
                knobs = [K5_KNOBS[(b + i) % len(K5_KNOBS)] for b in range(B)]
                temps, ks, ps = zip(*knobs)
                lh = (torch.randn((B, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
                c0 = (torch.randn((B, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
                noise = gumbel_noise((n, B, V), gen, DEV)
                args = (t, fw, fnorm, heads, tables, lh, c0, noise, temps, ks, ps)
                sn, sum_n = K2.fused_mtp_chain_batched(*args, cache_dtype=cache_dtype)
                same = True
                if multi:
                    so, sum_o = k5_multi(*args, cache_dtype=cache_dtype)
                    same = bool(torch.equal(sn, so)) and bool(torch.equal(sum_n, sum_o))
                rows_k2 = True
                for b, (tb, kb, pb) in enumerate(knobs):
                    row = (t, fw, fnorm, heads, tables, lh[b : b + 1], c0[b : b + 1],
                           noise[:, b : b + 1].contiguous(), tb, kb, pb)
                    s1, sum1 = (K2.fused_mtp_chain(*row, cache_dtype=cache_dtype)
                                if row_chain is None else row_chain(*row))
                    rows_k2 &= bool(torch.equal(s1[0], sn[b])) and bool(torch.equal(sum1[0],
                                                                                   sum_n[b]))
                if not (same and rows_k2):
                    log(f"K5 {label} B={B} cache={str(cache_dtype)[6:]} input {i}: equal to the "
                        f"launch-per-op chain {same}, rows equal to the B=1 chain {rows_k2}")
                equal += same and rows_k2
                total += 1
    ok = equal == total
    rows = "K2" if row_chain is None else "K3"
    log(f"K5 persistent vs {rows} rows{' and the launch-per-op chain' if multi else ''}, {label}: "
        f"B {list(batches)} x "
        f"caches {[str(d)[6:] for d in cache_dtypes]} x {inputs} inputs, knobs {K5_KNOBS} cycled "
        f"over the rows: {equal}/{total} chains equal bit for bit (sub-codes, sub_sum) -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"the persistent K5 differs from K2 or the launch-per-op chain ({label})")
    return total


def in_turns(label, old, new, iters, names=("launch sequence", "persistent")):
    """ms per call of ``old`` and ``new`` timed in turns (old, new, new,
    old); returns (new mean, old mean)."""
    o1 = time_ms(old, iters)
    n1 = time_ms(new, iters)
    n2 = time_ms(new, iters)
    o2 = time_ms(old, iters)
    log(f"{label} in turns ({names[0]}, {names[1]}, {names[1]}, {names[0]}): "
        f"{o1:.4f} {n1:.4f} {n2:.4f} {o2:.4f} ms; {names[1]} {(n1 + n2) / 2:.4f} vs "
        f"{(o1 + o2) / 2:.4f} ms [{CARD}]")
    return (n1 + n2) / 2, (o1 + o2) / 2


ONE_SLOT_BYTES = 24 * 1024  # most phases then take two stages or more (int8 K = 6144: 4 rows)


def one_slot_ring(run, probe_stall_ns=0, narrow=False):
    """``run()`` with the persistent kernels' plans cut to one ring slot of
    ONE_SLOT_BYTES (or four rows of the widest row, where that is more), so
    that a stage after a phase's first is issued right
    before it is read, and the probes' ring plans to one slot (each stage
    past the first issued ``probe_stall_ns`` after the block's warps reach
    their wait); the wrappers' cached entries are dropped before and
    after.  ``narrow``: the slot holds four rows of the plan's widest row,
    so every block's share of a phase spans the most stages, each copied
    only once the one before it is consumed (K9's o stage: its first copy
    lands during the attention phase, its later ones just before their
    read)."""
    real = persistent.device_plan
    real_probe = unit_probe.probe_plan

    def one_slot_probe(arm, R, K, NW, grid):
        plan = real_probe(arm, R, K, NW, grid)
        smem = persistent.smem_layout(1, plan.slot_bytes, plan.slot_rows, plan.in_bytes)
        return plan._replace(n_slots=1, smem_bytes=smem["total"], issue_stall_ns=probe_stall_ns)

    def one_slot(cfg, device, head_rows=0, batch=1, talker=None, lm_rows=0, unit_bytes=1,
                 grid=None, head_k=0, head_bytes=0, talker_bytes=0):
        device = torch.device(device)
        plan = persistent.make_plan(cfg, grid or persistent.grid_size(device), head_rows, batch,
                                    talker, lm_rows, unit_bytes, head_k, head_bytes, talker_bytes)
        # four rows of the widest row: the narrow slot, and the least one a
        # plan takes (the 1.7B bf16 down rows: 48 KB)
        widest = persistent.ROW_QUANTUM * max(
            int(K * persistent._kind_bytes(i, unit_bytes, head_bytes, talker_bytes))
            for i, (N, K) in enumerate(plan.shapes) if N)
        slot = widest if narrow else max(ONE_SLOT_BYTES, widest)
        plan = persistent._plan_at(slot, cfg, plan.grid, plan.shapes, batch, plan.n_sets,
                                   unit_bytes, head_bytes, talker_bytes)
        smem = persistent.smem_layout(1, plan.slot_bytes, plan.slot_rows, plan.union_bytes)
        return persistent.DevicePlan(plan._replace(n_slots=1, smem_bytes=smem["total"]), device)

    clear_entries()
    persistent.device_plan = one_slot
    unit_probe.probe_plan = one_slot_probe
    try:
        return run()
    finally:
        persistent.device_plan = real
        unit_probe.probe_plan = real_probe
        clear_entries()


def clear_entries():
    """Drop the wrappers' cached structs, scratch and plans."""
    K1._STEP_ENTRIES.clear()
    K1._BATCH_ENTRIES.clear()
    K2._CHAIN_ENTRIES.clear()
    K6._ENTRIES.clear()
    K7._ENTRIES.clear()
    K9._ENTRIES.clear()
    K10._ENTRIES.clear()
    unit_probe._PLANS.clear()


def trace_phases(label, plan, names, run):
    """One traced launch of a persistent kernel (``run``), its plan's trace
    on: per phase kind of ``names`` (one per grid barrier, in order), the
    slowest block's work (for a GEMV phase split into its input and its
    dot products; for a sampler phase, block 0's split into the sampler's
    steps), the mean block's, and the barrier's latency from the last
    arrival to the first departure.  Returns (us per launch, us per
    barrier, barriers)."""
    tr = plan.enable_trace(len(names))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        plan.disable_trace()
    tr = tr.cpu().to(torch.float64)
    nb = len(names)
    start, end = tr[1], tr[5 * nb + 2]
    mid, ready, dots = tr[2:5 * nb + 2:5], tr[3:5 * nb + 3:5], tr[4:5 * nb + 4:5]
    arrive, depart = tr[5:5 * nb + 5:5], tr[6:5 * nb + 6:5]
    prev = torch.cat([start[None], depart[:-1]])
    work = (arrive - prev) / 1e3
    gemv = ((mid > 0) & (ready > 0) & (dots > 0)).all(dim=1)
    parts = [(mid - prev) / 1e3, (ready - mid) / 1e3, (dots - ready) / 1e3, (arrive - dots) / 1e3]
    latency = (depart.min(dim=1).values - arrive.max(dim=1).values) / 1e3
    total = float(end.max() - start.min()) / 1e3
    # a sampler phase: block 0's marks after the top-k threshold, the softmax
    # and the top-p threshold (the other blocks wait at the barrier)
    sampler = (~gemv) & (mid[:, 0] > 0) & (ready[:, 0] > 0) & (dots[:, 0] > 0)
    kinds = {}
    for i, kind in enumerate(names):
        k = kinds.setdefault(kind, [0, 0.0, 0.0, 0.0, [0.0] * 4])
        k[0] += 1
        k[1] += float(work[i].max())
        k[2] += float(work[i].mean())
        k[3] += float(latency[i])
        if bool(gemv[i]):
            for j, part in enumerate(parts):
                k[4][j] += float(part[i].mean())
        elif bool(sampler[i]):
            for j, part in enumerate(parts):
                k[4][j] += float(part[i, 0])
    bar_us = float(latency.mean())
    log(f"trace {label}: {total:.1f} us per launch, {nb} grid barriers at {bar_us:.2f} us each "
        f"({nb * bar_us:.1f} us, {nb * bar_us / total:.1%}); per phase (count: slowest block's "
        f"work, mean block's [GEMV phases, mean block: input, wait for the first weight stage, "
        f"dot products, last refill; sampler phases, block 0: load and top-k threshold, softmax, "
        f"top-p threshold, draw and gather], barrier us): "
        + "; ".join(f"{kind} x{c}: {w / c:.2f}, {m / c:.2f} [" + ", ".join(
            f"{v / c:.2f}" for v in sub) + f"], {lat / c:.2f}"
            for kind, (c, w, m, lat, sub) in kinds.items())
        + f" [{CARD}]")
    return total, bar_us, nb


def step_phase_names(layers, last_barrier=False, batched=False):
    """The phase ending at each grid barrier of one persistent trunk pass
    (batched: K4's, whose down projection's input is one more phase)."""
    names = ["qkv", "attn", "o", "gu"] + (["silu"] if batched else []) + ["down"]
    names = names * layers
    return names if last_barrier else names[:-1]


def verify_phase_names(layers):
    """The phase ending at each grid barrier of one persistent verify pass
    (K6): K4's phases with the slot write after the qkv product."""
    names = ["qkv", "write", "attn", "o", "gu", "silu", "down"] * layers
    return names[:-1]


def chain_phase_names(layers, n, batched=False):
    """The phase ending at each grid barrier of one persistent chain (K2, K3,
    K5)."""
    names = step_phase_names(layers, True, batched) * 2
    for j in range(n):
        names += ["head"] + (["sample"] + step_phase_names(layers, True, batched)
                             if j + 1 < n else [])
    return names


def frame_phase_names(talker_layers, mtp_layers, n):
    """The phase ending at each grid barrier of one persistent frame (K7):
    code0's draw, the chain (K2's phases), the last draw with the next
    input, the talker step; the lm_head runs after the last barrier."""
    return (["code0"] + chain_phase_names(mtp_layers, n) + ["sample"]
            + ["talker " + k for k in step_phase_names(talker_layers, True)])


def check_chain(label, kernel_fn, plain_fn, knobs, cp, fw, heads, tables, fnorm, gen, iters,
                flip_rule=False, **kw):
    """A B=1 chain kernel (K2, K3) against its plain version on one seeded
    input and the same noise: sub-codes equal and sub_sum within K2_SUM_ABS.
    A first mismatch passes below K2_MARGIN_REL of score margin or, with
    ``flip_rule``, by K5's rule (a logit perturbation within K5_FLIP_EPS
    reaches the kernel's token)."""
    n, V = cp.num_steps, cp.subcode_vocab_size
    H = cp.transformer.hidden_size
    t = cp.transformer
    sp = SamplingParams.create(*knobs)
    mode = "greedy" if sp.greedy else f"sampled T={sp.temperature} k={sp.top_k} p={sp.top_p}"
    lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    noise = None if sp.greedy else gumbel_noise((n, 1, V), gen, DEV)

    def run(fn):
        return fn(t, fw, fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k,
                  sp.top_p, **kw)

    sk, sum_k = run(kernel_fn)
    # the plain run records each step's sampler inputs for the margin check
    seen = []
    real = K2.gumbel_topk_topp_sample

    def record(logits, g, *a):
        seen.append((logits.clone(), None if g is None else g.clone()))
        return real(logits, g, *a)

    K2.gumbel_topk_topp_sample = record
    try:
        (sp_, sum_p), plain_call_ms = timed_call(lambda: run(plain_fn))
    finally:
        K2.gumbel_topk_topp_sample = real
    kern, plain = sk[0].tolist(), sp_[0].tolist()
    diff = [j for j in range(n) if kern[j] != plain[j]]
    if diff:
        j = diff[0]
        logits, g = seen[j]
        score = logits[0] if sp.greedy else scale_by_temperature(logits[0], sp.temperature) + g[0]
        margin = float((score[kern[j]] - score[plain[j]]).abs() / score.abs().max())
        eps = flip_eps(logits, g, (sp.temperature, sp.top_k, sp.top_p), kern[j], gen) if (
            flip_rule) else None
        ok = margin < K2_MARGIN_REL or eps is not None
        log(f"{label} {mode}: first sub-code mismatch at step {j}: kernel {kern[j]} plain "
            f"{plain[j]} relative score margin {margin:.3e} (tol {K2_MARGIN_REL})"
            + (f", flip eps {eps} (tol {K5_FLIP_EPS[-1]})" if flip_rule else ""))
        err = float("nan")
    else:
        err = float((sum_k - sum_p).abs().max())
        ok = err < K2_SUM_ABS
    ms = plain_ms = float("nan")
    if iters:
        ms = time_ms(lambda: run(kernel_fn), iters)
        plain_ms = plain_call_ms  # the checked call (with its sampler inputs recorded)
    log(f"{label} {mode}: subcodes kernel {kern} plain {plain} equal={not diff} sub_sum "
        f"max_abs_err={err:.3e} (tol {K2_SUM_ABS}) kernel {ms:.4f} ms/chain plain "
        f"{plain_ms:.4f} ms/chain -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"{label} {mode} disagrees with its plain version")
    return 0.0 if diff else err, ms, plain_ms


def k4_inputs(t, B, T, cache_dtype, gen):
    """A seeded batch: x [B, H], caches with each row's slots past its
    position zeroed, and the per-row positions (unclamped) on the device."""
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    pos = [K4_POSITIONS[b % len(K4_POSITIONS)] for b in range(B)]
    x = torch.randn((B, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc = (torch.randn((L, B, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, B, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    for b, p in enumerate(pos):
        kc[:, b, :, min(p, T - 1):] = 0
        vc[:, b, :, min(p, T - 1):] = 0
    return x, kc, vc, pos


@dataclasses.dataclass
class K4Run:
    """One seeded batch through K4 and its plain version."""

    err: float  # max |x_kernel - x_plain|
    rel: torch.Tensor  # [B] per-row max |dx| / max |x_plain|
    slot_err: float  # max abs error of the k and v written at the rows' positions
    slot_rel: torch.Tensor  # [B]
    untouched: bool  # the kernel left every other slot as it was
    rows_equal_k1: bool  # every row equals K1 on it, bit for bit (when checked)


def k4_run(t, fw, B, T, cache_dtype, gen, against_k1=False) -> K4Run:
    x, kc, vc, pos = k4_inputs(t, B, T, cache_dtype, gen)
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    pos_dev = torch.tensor(pos, device=DEV)
    xk, _, _ = K1.fused_decode_step_batched(t, fw, x, pos_dev, kk, vk)
    xp, _, _ = K1.fused_decode_step_batched_reference(t, fw, x, pos_dev, kp, vp)
    torch.cuda.synchronize()
    rows = torch.arange(B, device=DEV)
    slots = torch.clamp(pos_dev, max=T - 1)
    written = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    written[rows, slots] = True
    slot_k = torch.stack((kk[:, rows, :, slots], vk[:, rows, :, slots])).float()  # [2, B, L, nk, d]
    slot_p = torch.stack((kp[:, rows, :, slots], vp[:, rows, :, slots])).float()
    slot_abs = (slot_k - slot_p).abs().flatten(2).amax(dim=(0, 2))  # [B]
    dx = (xk - xp).abs().amax(dim=1)
    keep = ~written[None, :, None, :]
    untouched = bool(torch.equal(kk.masked_select(keep[..., None]), kc.masked_select(keep[..., None])))
    untouched &= bool(torch.equal(vk.masked_select(keep[..., None]), vc.masked_select(keep[..., None])))
    equal_k1 = True
    if against_k1:
        for b, p in enumerate(pos):
            k1, v1 = kc[:, b : b + 1].clone(), vc[:, b : b + 1].clone()
            x1, _, _ = K1.fused_decode_step(t, fw, x[b : b + 1], p, k1, v1)
            equal_k1 &= bool(torch.equal(x1[0], xk[b])) and bool(
                torch.equal(k1[:, 0], kk[:, b])) and bool(torch.equal(v1[:, 0], vk[:, b]))
    return K4Run(float(dx.max()), (dx / xp.abs().amax(dim=1)).cpu(), float(slot_abs.max()),
                 (slot_abs / slot_p.abs().flatten(2).amax(dim=(0, 2))).cpu(), untouched, equal_k1)


def time_k4(t, fw, B, T, cache_dtype, gen, iters):
    """Kernel and plain ms per step on one batch."""
    x, kc, vc, pos = k4_inputs(t, B, T, cache_dtype, gen)
    pos_dev = torch.tensor(pos, device=DEV)
    kp, vp = kc.clone(), vc.clone()
    ms = time_ms(lambda: K1.fused_decode_step_batched(t, fw, x, pos_dev, kc, vc), iters)
    plain_ms = time_ms(
        lambda: K1.fused_decode_step_batched_reference(t, fw, x, pos_dev, kp, vp), 1, 0)
    return ms, plain_ms


def check_k4_deep(name, t, fw, B, T, gen, iters):
    """One batch at full depth with a bf16 cache: the deep limits, untouched
    slots, and every row equal to K1 on it."""
    r = k4_run(t, fw, B, T, torch.bfloat16, gen, against_k1=True)
    rel = float(r.rel.max())
    ms, plain_ms = time_k4(t, fw, B, T, torch.bfloat16, gen, iters)
    ok = rel < K1_DEEP_X_REL and r.slot_err < K1_DEEP_SLOT_ABS and r.untouched and r.rows_equal_k1
    log(f"K4 {name}: L={t.num_layers} B={B} T={T} cache=bfloat16 x max_abs_err={r.err:.3e} "
        f"max row rel={rel:.3e} (tol {K1_DEEP_X_REL}) slot max_abs_err={r.slot_err:.3e} (tol "
        f"{K1_DEEP_SLOT_ABS}) untouched_slots_equal={r.untouched} rows_equal_K1="
        f"{r.rows_equal_k1} kernel {ms:.4f} ms plain {plain_ms:.4f} ms -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K4 {name} B={B} disagrees with its plain version or with K1")
    return r.err, ms, plain_ms


def check_k4_shallow(t, fw, B, T, cache_dtype, gen):
    """K1_TIGHT_INPUTS seeded batches on one layer: every row within the
    flip-tolerant limits, and at least the K1 share of rows tight (a flip
    hits some rows; a systematic fault hits every row)."""
    runs = [k4_run(t, fw, B, T, cache_dtype, gen, against_k1=i == 0) for i in range(K1_TIGHT_INPUTS)]
    rel = max(float(r.rel.max()) for r in runs)
    slot_err = max(r.slot_err for r in runs)
    tight = sum(int(((r.rel <= K1_TIGHT_REL) & (r.slot_rel <= K1_TIGHT_REL)).sum()) for r in runs)
    need = K1_TIGHT_MIN * B
    ok = (rel < K1_SHALLOW_X_REL and slot_err < K1_SHALLOW_SLOT_ABS and tight >= need
          and all(r.untouched for r in runs) and runs[0].rows_equal_k1)
    log(f"K4 talker-1-layer: B={B} T={T} cache={str(cache_dtype)[6:]} {len(runs)} batches: x max "
        f"row rel {rel:.3e} (tol {K1_SHALLOW_X_REL}) slot max_abs_err={slot_err:.3e} (tol "
        f"{K1_SHALLOW_SLOT_ABS}) tight rows {tight}/{len(runs) * B} (need {need}) "
        f"untouched_slots_equal={all(r.untouched for r in runs)} rows_equal_K1="
        f"{runs[0].rows_equal_k1} -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K4 1-layer B={B} disagrees with its plain version or with K1")
    return max(r.err for r in runs)


def k6_inputs(t, B, S, T, starts, cache_dtype, gen):
    """A seeded verify batch: x [B, S, H], caches with each stream's slots
    from its (clamped) start on zeroed, and the starts on the device."""
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    x = torch.randn((B, S, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc = (torch.randn((L, B, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, B, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    for b, p in enumerate(starts):
        kc[:, b, :, min(p, T - S):] = 0
        vc[:, b, :, min(p, T - S):] = 0
    return x, kc, vc, torch.tensor(starts, device=DEV)


@dataclasses.dataclass
class K6Run:
    """One seeded verify batch through K6 and its plain version."""

    err: float  # max |x_kernel - x_plain|
    rel: torch.Tensor  # [B * S] per-row max |dx| / max |x_plain|
    slot_err: float  # max abs error of the k and v written at the new slots
    slot_rel: torch.Tensor  # [B * S]
    untouched: bool  # the kernel left every other slot as it was
    rows_equal_steps: bool  # equal to S successive K1 (B=1) / K4 steps, bit for bit
    equal_multi: Optional[bool]  # equal to the launch-per-op pass's, bit for bit (None: bf16)


def k6_run(t, fw, B, S, T, starts, cache_dtype, gen, against_steps=False, plain=True) -> K6Run:
    """K6 on one seeded batch against the launch-per-op pass (bit for bit),
    its plain version (unless ``plain`` is False: the errors are then NaN)
    and, with ``against_steps``, the S successive K1 / K4 steps."""
    x, kc, vc, pos_dev = k6_inputs(t, B, S, T, starts, cache_dtype, gen)
    kk, vk = kc.clone(), vc.clone()
    xk, _, _ = K6.fused_verify_step(t, fw, x, pos_dev, kk, vk)
    if plain:
        kp, vp = kc.clone(), vc.clone()
        xp, _, _ = K6.fused_verify_step_reference(t, fw, x, pos_dev, kp, vp)
    else:  # the errors below are then NaN
        xp, kp, vp = xk, kk, vk
    equal_multi = None  # the launch-per-op pass takes int8 units only
    if fw.wqkv.dtype == torch.int8:
        km, vm = kc.clone(), vc.clone()
        xm = k6_multi(t, fw, x, pos_dev, km, vm)
        torch.cuda.synchronize()
        equal_multi = bool(torch.equal(xk, xm)) and bool(torch.equal(kk, km)) and bool(
            torch.equal(vk, vm))
        del km, vm
    first = torch.clamp(pos_dev, 0, T - S)
    slots = first[:, None] + torch.arange(S, device=DEV)  # [B, S]
    rows = torch.arange(B, device=DEV)[:, None].expand(B, S)
    written = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    written[rows, slots] = True
    slot_k = torch.stack((kk[:, rows, :, slots], vk[:, rows, :, slots])).float()  # [2, B, S, L, nk, d]
    slot_p = torch.stack((kp[:, rows, :, slots], vp[:, rows, :, slots])).float()
    slot_abs = (slot_k - slot_p).abs().flatten(3).amax(dim=(0, 3))  # [B, S]
    slot_ref = slot_p.abs().flatten(3).amax(dim=(0, 3))
    dx = (xk - xp).abs().amax(dim=2)  # [B, S]
    keep = ~written[None, :, None, :, None]
    untouched = bool(torch.equal(kk.masked_select(keep), kc.masked_select(keep)))
    untouched &= bool(torch.equal(vk.masked_select(keep), vc.masked_select(keep)))
    equal = True
    if against_steps:
        k1, v1 = kc.clone(), vc.clone()
        for s in range(S):
            if B == 1:
                x1, _, _ = K1.fused_decode_step(t, fw, x[:, s], int(first[0]) + s, k1, v1)
            else:
                x1, _, _ = K1.fused_decode_step_batched(t, fw, x[:, s], first + s, k1, v1)
            equal &= bool(torch.equal(x1, xk[:, s]))
        equal &= bool(torch.equal(k1, kk)) and bool(torch.equal(v1, vk))
    nan = 1.0 if plain else float("nan")
    return K6Run(nan * float(dx.max()), nan * (dx / xp.abs().amax(dim=2)).flatten().cpu(),
                 nan * float(slot_abs.max()), nan * (slot_abs / slot_ref).flatten().cpu(),
                 untouched, equal, equal_multi)


def time_k6(t, fw, B, S, T, starts, gen, iters):
    """Kernel, plain and bound ms of one verify pass (bf16 cache)."""
    x, kc, vc, pos_dev = k6_inputs(t, B, S, T, starts, torch.bfloat16, gen)
    kp, vp = kc.clone(), vc.clone()
    ms = time_ms(lambda: K6.fused_verify_step(t, fw, x, pos_dev, kc, vc), iters)
    plain_ms = time_ms(lambda: K6.fused_verify_step_reference(t, fw, x, pos_dev, kp, vp), 1, 0)
    ctx = [min(p, T - S) for p in starts]  # cache slots read before the new ones
    return ms, plain_ms, step_bound(t, fw, B * S, ctx, S, torch.bfloat16)


def check_k6_deep(name, t, fw, B, S, T, starts, gen, iters):
    """One verify batch at full depth with a bf16 cache: the deep K1 limits,
    untouched slots, and every row equal to the K1 / K4 steps it replaces."""
    r = k6_run(t, fw, B, S, T, starts, torch.bfloat16, gen, against_steps=True)
    rel = float(r.rel.max())
    ms, plain_ms, bound = time_k6(t, fw, B, S, T, starts, gen, iters)
    ok = (rel < K1_DEEP_X_REL and r.slot_err < K1_DEEP_SLOT_ABS and r.untouched
          and r.rows_equal_steps and r.equal_multi is not False)
    log(f"K6 {name}: L={t.num_layers} B={B} S={S} T={T} starts={starts} cache=bfloat16 x "
        f"max_abs_err={r.err:.3e} max row rel={rel:.3e} (tol {K1_DEEP_X_REL}) slot "
        f"max_abs_err={r.slot_err:.3e} (tol {K1_DEEP_SLOT_ABS}) untouched_slots_equal="
        f"{r.untouched} rows_equal_{'K1' if B == 1 else 'K4'}_steps={r.rows_equal_steps} "
        f"equal_to_launch_sequence={r.equal_multi} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {bound[0]:.4f} ms ({bound[1]}) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K6 {name} B={B} S={S} disagrees with its plain version or the steps")
    return r.err, ms, plain_ms, bound


def check_k6_shallow(t, fw, B, S, T, starts, cache_dtype, gen):
    """K1_TIGHT_INPUTS seeded verify batches on one layer: every row within
    the flip-tolerant limits and at least the K1 share of rows tight."""
    runs = [k6_run(t, fw, B, S, T, starts, cache_dtype, gen, against_steps=i == 0)
            for i in range(K1_TIGHT_INPUTS)]
    rel = max(float(r.rel.max()) for r in runs)
    slot_err = max(r.slot_err for r in runs)
    tight = sum(int(((r.rel <= K1_TIGHT_REL) & (r.slot_rel <= K1_TIGHT_REL)).sum()) for r in runs)
    need = K1_TIGHT_MIN * B * S
    multi = sum(r.equal_multi is not False for r in runs)
    ok = (rel < K1_SHALLOW_X_REL and slot_err < K1_SHALLOW_SLOT_ABS and tight >= need
          and all(r.untouched for r in runs) and runs[0].rows_equal_steps and multi == len(runs))
    log(f"K6 talker-1-layer: B={B} S={S} T={T} starts={starts} cache={str(cache_dtype)[6:]} "
        f"{len(runs)} batches: x max row rel {rel:.3e} (tol {K1_SHALLOW_X_REL}) slot "
        f"max_abs_err={slot_err:.3e} (tol {K1_SHALLOW_SLOT_ABS}) tight rows {tight}/"
        f"{len(runs) * B * S} (need {need}) untouched_slots_equal="
        f"{all(r.untouched for r in runs)} rows_equal_steps={runs[0].rows_equal_steps} "
        f"equal_to_launch_sequence {multi}/{len(runs)} -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K6 1-layer B={B} S={S} disagrees with its plain version or the steps")
    return max(r.err for r in runs)


def check_k6_equal(name, t, fw, cases, gen, cache_dtypes=(torch.bfloat16, torch.float32),
                   stall_ns=0):
    """The persistent K6 on one seeded batch per (B, S, T, starts) of
    ``cases`` and cache dtype: x and both caches equal the launch-per-op
    pass's (``k6_multi``) bit for bit, and every row equals the S successive
    K1 (B=1) or K4 steps it stands for.  With ``stall_ns`` each slot write
    first waits that long (the plan's ``write_stall_ns``): the write phase's
    grid barrier must then hold every reader back, where a missing barrier
    would let the attention read a slot before its write (with no stall the
    writes land within a microsecond, before any reader gets there).
    Returns the passes compared."""
    equal = total = 0
    for B, S, T, starts in cases:
        for cache_dtype in cache_dtypes:
            plan = K6._verify_entry(t, fw, B, S, T, cache_dtype,
                                    torch.device("cuda", torch.cuda.current_device())).plan
            plan.struct.write_stall_ns = stall_ns
            try:
                r = k6_run(t, fw, B, S, T, starts, cache_dtype, gen, against_steps=True,
                           plain=False)
            finally:
                plan.struct.write_stall_ns = 0
            if not (r.equal_multi and r.rows_equal_steps):
                log(f"K6 {name} B={B} S={S} T={T} starts={starts} cache={str(cache_dtype)[6:]}: "
                    f"equal to the launch sequence {r.equal_multi}, rows equal to the steps "
                    f"{r.rows_equal_steps}")
            equal += r.equal_multi and r.rows_equal_steps
            total += 1
    ok = equal == total
    log(f"K6 persistent vs the launch sequence and the K1 / K4 steps, {name}: L={t.num_layers} "
        f"(B, S, T, starts) {[c[:4] for c in cases]} x caches "
        f"{[str(d)[6:] for d in cache_dtypes]}{f', writes stalled {stall_ns} ns' if stall_ns else ''}"
        f": {equal}/{total} passes equal bit for bit (x, k and v caches) -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"the persistent K6 differs from the launch sequence or the steps "
                           f"({name})")
    return total


def flip_eps(logits, g, knobs, token, gen):
    """The smallest eps in K5_FLIP_EPS at which the plain sampler, on logits
    scaled elementwise by (1 + eps * N(0, 1)) and the same noise, picks
    ``token``; None if none does."""
    t, k, p = knobs
    for eps in K5_FLIP_EPS:
        for _ in range(16):
            wiggle = 1 + eps * torch.randn(logits.shape, generator=gen, device=DEV)
            if int(K2.gumbel_topk_topp_sample(logits * wiggle, g, t, k, p)[0]) == token:
                return eps
    return None


def check_k5(B, cp, fw, heads, tables, fnorm, gen, iters, cache_dtype=torch.bfloat16,
             row_chain=None):
    """K5 against its plain version on mixed per-row knobs and the same noise
    (a row's first mismatch passes when a logit perturbation within
    K5_FLIP_EPS reaches it), and every row against the B=1 chain on that
    row's inputs and noise, bit for bit: K2 on ``cache_dtype``, or
    ``row_chain`` (K3 for bf16 units, on a float32 cache)."""
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    t = cp.transformer
    knobs = [K5_KNOBS[b % len(K5_KNOBS)] for b in range(B)]
    temps, ks, ps = zip(*knobs)
    lh = (torch.randn((B, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((B, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    noise = gumbel_noise((n, B, V), gen, DEV)

    def run(fn):
        return fn(t, fw, fnorm, heads, tables, lh, c0, noise, temps, ks, ps,
                  cache_dtype=cache_dtype)

    sk, sum_k = run(K2.fused_mtp_chain_batched)
    seen = []  # the plain run's sampler inputs, step-major, row-minor
    real = K2.gumbel_topk_topp_sample

    def record(logits, g, *a):
        seen.append((logits.clone(), None if g is None else g.clone()))
        return real(logits, g, *a)

    K2.gumbel_topk_topp_sample = record
    try:
        # the checked call, timed (its sampler inputs recorded)
        (sp_, sum_p), plain_ms = timed_call(lambda: run(K2.fused_mtp_chain_batched_reference))
    finally:
        K2.gumbel_topk_topp_sample = real
    rows_k2 = True
    for b, (tb, kb, pb) in enumerate(knobs):
        row = (t, fw, fnorm, heads, tables, lh[b : b + 1], c0[b : b + 1],
               noise[:, b : b + 1].contiguous(), tb, kb, pb)
        s1, sum1 = (K2.fused_mtp_chain(*row, cache_dtype=cache_dtype) if row_chain is None
                    else row_chain(*row))
        rows_k2 &= bool(torch.equal(s1[0], sk[b])) and bool(torch.equal(sum1[0], sum_k[b]))
    torch.cuda.synchronize()
    kern, plain = sk.tolist(), sp_.tolist()
    ok, flips, equal_rows = True, [], []
    for b in range(B):
        diff = [j for j in range(n) if kern[b][j] != plain[b][j]]
        if not diff:
            equal_rows.append(b)
            continue
        j = diff[0]
        logits, g = seen[j * B + b]
        eps = flip_eps(logits, g, knobs[b], kern[b][j], gen)
        flips.append((b, j, eps))
        ok &= eps is not None
    err = float((sum_k[equal_rows] - sum_p[equal_rows]).abs().max()) if equal_rows else 0.0
    ok = ok and err < K2_SUM_ABS and rows_k2 and len(equal_rows) >= K5_MIN_EQUAL * B
    ms = time_ms(lambda: run(K2.fused_mtp_chain_batched), iters)
    log(f"K5 B={B} {str(fw.wqkv.dtype)[6:]} units mixed knobs {K5_KNOBS}: rows equal "
        f"{len(equal_rows)}/{B} (need "
        f"{K5_MIN_EQUAL:.0%}), first mismatches (row, step, flip eps) {flips} (tol "
        f"{K5_FLIP_EPS[-1]}); sub_sum "
        f"max_abs_err over equal rows={err:.3e} (tol {K2_SUM_ABS}); rows_equal_"
        f"{'K2' if row_chain is None else 'K3'}={rows_k2} "
        f"kernel {ms:.4f} ms/chain plain {plain_ms:.4f} ms/chain -> {'ok' if ok else 'FAIL'} "
        f"[{CARD}]")
    if not ok:
        raise RuntimeError(f"K5 B={B} disagrees with its plain version or with K2")
    return err, ms, plain_ms


def byte_level_tokenizer(workdir: str) -> Tokenizer:
    """All 256 byte proxies plus a few merges (the tests' tiny vocab)."""
    proxy = byte_to_proxy()
    tokens = [proxy[b] for b in range(256)]
    merges = []
    for a, b in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w"),
                 ("o", "r"), ("Ġw", "or"), ("l", "d"), ("Ġwor", "ld")]:
        merges.append((a, b))
        if a + b not in tokens:
            tokens.append(a + b)
    vocab_path = os.path.join(workdir, "vocab.json")
    merges_path = os.path.join(workdir, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump({tok: i for i, tok in enumerate(tokens)}, f, ensure_ascii=True)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return Tokenizer(vocab_path, merges_path)


def instruct_segments(eng, instruct, B):
    """(prefill keyword arguments, instruct bucket) of an instruction, as the
    engine builds them."""
    if instruct is None:
        return {}, 0
    ids = eng._tokenize(instruct)
    bucket = -(-len(ids) // eng.text_bucket) * eng.text_bucket
    return dict(instruct_ids=torch.tensor([ids + [0] * (bucket - len(ids))] * B, device=DEV),
                instruct_len=torch.full((B,), len(ids), device=DEV)), bucket


def fixed_length_run(eng, frames_total: int, texts, instruct=None):
    """``frames_total`` frames of len(texts) streams with EOS forbidden,
    through the generate callables and the engine's cache growth, as the
    engine loop drives them, with any host sync inside a chunk raising."""
    B = len(texts)
    sp = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    id_lists = [eng._tokenize(text) for text in texts]
    lang_id = LANG_ENGLISH
    segments, i_bucket = instruct_segments(eng, instruct, B)
    P = prompt_length(lang_id, False, i_bucket)
    ladder = eng.kv_ladder
    bidx = next(i for i, b in enumerate(ladder) if b >= P + eng.chunk_len + 1)
    gens = []
    for b in range(B):  # one noise stream per stream
        gens.append(torch.Generator(device=DEV))
        gens[-1].manual_seed(SEED + b)
    width = max(len(ids) for ids in id_lists)
    ids_t = torch.tensor([ids + [0] * (width - len(ids)) for ids in id_lists], device=DEV)
    lens = torch.tensor([len(ids) for ids in id_lists], device=DEV)
    t0 = time.perf_counter()
    state, bundle = eng._get_fns(lang_id, ladder[bidx], eng.first_chunk_len, B).prefill(
        eng.params, ids_t, lens, gens, **segments)
    if state.pos.tolist() != [P] * B:
        raise RuntimeError(f"prompt positions {state.pos.tolist()} != {P}")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    frames, valid, buckets = [], [], []
    steps, decode_s = 0, 0.0
    while steps < frames_total:
        cur = min(eng.first_chunk_len if steps == 0 else eng.chunk_len, frames_total - steps)
        while P + steps + cur + 1 > ladder[bidx] and bidx + 1 < len(ladder):
            bidx += 1
            state = eng._grow_state(state, ladder[bidx])
        buckets.append(state.cache.max_len)
        fns = eng._get_fns(lang_id, ladder[bidx], cur, B)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the chunk raises
        try:
            state, fr, vd = fns.decode(eng.params, state, bundle.trailing,
                                       bundle.trailing_len, bundle.tts_pad_embed, sp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        frames.append(fr.cpu())
        decode_s += time.perf_counter() - t0
        valid.append(vd.cpu())
        steps += cur
    codes = torch.cat(frames, dim=1)
    audio = vocoder_forward(eng.cfg.vocoder, eng.params["vocoder"], codes.to(DEV)).cpu()
    return codes, torch.cat(valid, dim=1), audio, buckets, prefill_s, decode_s


def check_fixed_run(eng, n_frames, texts, card_line, instruct=None):
    """A fixed-length run: every frame valid, finite audio, the cache grown
    256 -> 512.  Returns ms per (batched) frame."""
    B = len(texts)
    codes, valid, audio, buckets, prefill_s, decode_s = fixed_length_run(eng, n_frames, texts,
                                                                         instruct)
    if codes.shape != (B, n_frames, 16) or not bool(valid.all()):
        raise RuntimeError(f"fixed-length run B={B}: wrong frame count or an invalid frame")
    if audio.shape != (B, n_frames * SAMPLES_PER_FRAME) or not bool(torch.isfinite(audio).all()):
        raise RuntimeError(f"fixed-length run B={B}: bad audio")
    if buckets[0] != 256 or 512 not in buckets:
        raise RuntimeError(f"fixed-length run B={B} did not grow the cache 256 -> 512: {buckets}")
    ms_frame = decode_s * 1e3 / n_frames
    log(f"fixed run B={B}: {n_frames} frames, buckets {sorted(set(buckets))}, prefill "
        f"{prefill_s * 1e3:.1f} ms, {ms_frame:.3f} ms per {'batched ' if B > 1 else ''}frame, "
        f"{'aggregate ' if B > 1 else ''}RTF {B * (n_frames / 12) / (prefill_s + decode_s):.2f}x "
        f"[{card_line}]")
    return ms_frame


KERNELS = (K1.fused_decode_step, K2.fused_mtp_chain, K1.fused_decode_step_batched,
           K2.fused_mtp_chain_batched, K6.fused_verify_step, K3.fused_mtp_chain_streamed,
           K8.flash_attend, K7.fused_frame_step, P1.chain, P2.chain, K9.fused_decode_step_tp,
           K10.fused_mtp_chain_tp)
KERNEL_IDS = ("K1", "K2", "K4", "K5", "K6", "K3", "K8", "K7", "P1", "P2", "K9", "K10")


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0
    ENTRY_CALLS.clear()


def launches():
    """Launch counts in KERNEL_IDS' order."""
    return tuple(fn.launches for fn in KERNELS)


def counts_of(**n):
    """Launch counts in KERNEL_IDS' order from counts by kernel id."""
    return tuple(n.get(k, 0) for k in KERNEL_IDS)


def b1_chain(eng):
    """The id of the chain kernel of ``eng``'s B=1 frames: K2, or K3 for a
    trunk past K2's residency gate (the 1.7B int8 trunk, every bf16 one)."""
    chain = chain_kernel(eng.cfg.code_predictor, eng.params["code_predictor"], 1)
    return "K3" if chain is K3.fused_mtp_chain_streamed else "K2"


def check_launches(phase, want):
    """``want``: counts in KERNEL_IDS' order; the kernels past its end must
    not have launched."""
    want = tuple(want) + (0,) * (len(KERNELS) - len(want))
    got = launches()
    if got != want:
        raise RuntimeError(f"{phase}: launches {dict(zip(KERNEL_IDS, got))}, expected "
                           f"{dict(zip(KERNEL_IDS, want))}")
    multi = {k: n for k, n in ENTRY_CALLS.items() if k in MULTI_ENTRIES}
    if multi:
        raise RuntimeError(f"{phase}: the path ran launch-per-op entries {multi}")
    log(f"launches on the main path, {phase}: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, got)))
    return got


BATCH_TEXTS = [
    "hello world", "hello", "hello world, hello world", "a quick test of the batch",
    "hello world, this is a longer request for the batched decoder",
    "world", "hello hello hello", "the last of eight",
]


def batched_phase(eng, card_line):
    """synthesize_batch on 8 texts with per-stream seeds, then fixed-length
    batched runs at B=8 and B=32."""
    reset_launches()
    t0 = time.perf_counter()
    results = eng.synthesize_batch(BATCH_TEXTS, language="en", temperature=0.8, top_k=50,
                                   top_p=0.95, max_tokens=48, seed=list(range(len(BATCH_TEXTS))))
    wall = time.perf_counter() - t0
    decoded = results[0].metrics.decoded_frames
    for r in results:
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError("bad synthesize_batch output")
    audio_s = sum(r.metrics.audio_seconds for r in results)
    log(f"synthesize_batch B={len(results)}: frames {[r.metrics.frames for r in results]} "
        f"({decoded} decoded), {results[0].metrics.stage_seconds['decode'] * 1e3 / decoded:.3f} "
        f"ms per batched frame decode, aggregate RTF {audio_s / wall:.2f}x, TTFA "
        f"{results[0].metrics.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
    counts = [check_launches("synthesize_batch", (0, 0, decoded, decoded, 0))]
    ms = {}
    for B in (8, 32):
        reset_launches()
        texts = [BATCH_TEXTS[b % len(BATCH_TEXTS)] for b in range(B)]
        ms[B] = check_fixed_run(eng, FIXED_FRAMES, texts, card_line)
        counts.append(check_launches(f"fixed run B={B}",
                                     (0, 0, FIXED_FRAMES, FIXED_FRAMES, 0)))
    # one K4 and one K5 launch per batched frame: the device ops per frame
    # are the plain ops plus two
    for B in (8, 32):
        profile_frames(eng, f"batched B={B}", card_line, B=B)
    return [sum(c) for c in zip(*counts)], ms


POOL_REQUESTS = [  # (text, language, knobs, max_tokens): lengths halved to keep the smoke
    ("hello world", "en", (0.8, 50, 0.95), 20),  # inside its time limit
    ("你好，世界", "zh", (0.8, 50, 0.95), 16),
    ("hello", "auto", (0.0, 50, 0.95), 12),
    ("hello world, this is a longer pooled request", "en", (0.9, 30, 0.9), 32),
    ("こんにちは世界", "ja", (0.8, 50, 0.95), 24),
    ("hello hello", "en", (1.0, 0, 1.0), 12),
    ("世界", "zh", (0.7, 1, 0.9), 20),
    ("a short one", "en", (0.8, 50, 0.95), 8),
    ("hello world again", "auto", (0.0, 50, 0.95), 28),
    ("the tenth request", "en", (0.8, 50, 0.95), 16),
    ("one more for the queue", "en", (0.6, 40, 0.8), 24),
]
STREAMED_REQUEST = ("hello world, streamed through the pool", "en", (0.8, 50, 0.95), 24)


def pool_phase(eng, card_line):
    """12 requests (one streamed) through an 8-slot pool; then the greedy and
    seeded checks, and two requests over HTTP."""
    pool = ContinuousBatcher(eng, pool_size=8, chunk_len=16, kv_bucket=eng.kv_ladder[0])
    try:
        reset_launches()
        t0 = time.perf_counter()
        handle = pool.submit_stream(STREAMED_REQUEST[0], language=STREAMED_REQUEST[1],
                                    temperature=STREAMED_REQUEST[2][0],
                                    top_k=STREAMED_REQUEST[2][1], top_p=STREAMED_REQUEST[2][2],
                                    max_tokens=STREAMED_REQUEST[3], seed=SEED)
        futs = [pool.submit(text, language=lang, temperature=k[0], top_k=k[1], top_p=k[2],
                            max_tokens=mt, seed=SEED + i)
                for i, (text, lang, k, mt) in enumerate(POOL_REQUESTS)]
        items = list(handle)
        results = [f.result(timeout=600) for f in futs] + [items[-1]]
        wall = time.perf_counter() - t0
        streamed = np.concatenate(items[:-1]) if len(items) > 1 else np.zeros(0, np.float32)
        if not np.array_equal(streamed, items[-1].audio):
            raise RuntimeError("pool: streamed chunks differ from the retired audio")
        for (text, lang, _, mt), r in zip(POOL_REQUESTS + [STREAMED_REQUEST], results):
            if (r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,)
                    or not np.isfinite(r.audio).all() or not 0 < len(r.codes) <= mt):
                raise RuntimeError(f"pool: bad result for {text!r}")
            first = r.metrics.ttfa_seconds
            log(f"  pool {lang} {len(r.codes)} frames: "
                + (f"TTFA {first * 1e3:.1f} ms (streamed)" if first is not None else
                   f"result after {r.metrics.total_seconds * 1e3:.1f} ms (first audio = result)")
                + f" [{card_line}]")
        chunks = pool.stats["chunks"]
        audio_s = sum(r.metrics.audio_seconds for r in results)
        log(f"pool: 12 requests through 8 slots in {wall:.2f} s, {chunks} chunks of 16 frames, "
            f"aggregate RTF {audio_s / wall:.2f}x [{card_line}]")
        counts = [check_launches("pool", counts_of(K1=1, **{b1_chain(eng): 1}, K4=chunks * 16,
                                                   K5=chunks * 16))]

        reset_launches()
        chunks0 = pool.stats["chunks"]
        text = "hello world, greedy through the pool"
        got = pool.synthesize(text, language="en", temperature=0.0, max_tokens=48)
        counts.append(check_launches("pool greedy", (0, 0, 16 * (pool.stats["chunks"] - chunks0),
                                                     16 * (pool.stats["chunks"] - chunks0), 0)))
        want = eng.synthesize(text, language="en", temperature=0.0, max_tokens=48)
        equal = np.array_equal(got.codes, want.codes)
        log(f"pool greedy vs synthesize at B=1: {len(got.codes)} frames, codes equal={equal}")
        if not equal:
            raise RuntimeError("pool greedy output differs from synthesize at B=1")

        kw = dict(language="en", temperature=0.8, top_k=50, top_p=0.95, max_tokens=16, seed=123)
        alone = pool.synthesize("hello world, seeded", **kw)
        mates = [pool.submit(t, language=lang, temperature=0.9, max_tokens=16)
                 for t, lang, _, _ in POOL_REQUESTS[:6]]
        among = pool.submit("hello world, seeded", **kw)
        for f in mates:
            f.result(timeout=600)
        equal = np.array_equal(among.result(timeout=600).codes, alone.codes)
        log(f"pool seeded request alone vs among 6 co-tenants: codes equal={equal}")
        if not equal:
            raise RuntimeError("a seeded pool request depends on its co-tenants")

        httpd = make_http_server(pool, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            for body in ({"text": "hello world", "language": "en", "max_tokens": 24, "seed": 1},
                         {"text": "hello", "temperature": 0.0, "max_tokens": 12}):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{httpd.server_address[1]}/synthesize",
                    data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    wav = r.read()
                    if r.headers["Content-Type"] != "audio/wav" or wav[:4] != b"RIFF":
                        raise RuntimeError("HTTP facade returned no WAV")
                log(f"http /synthesize {body['text']!r}: {len(wav)} WAV bytes, X-RTF "
                    f"{r.headers['X-RTF']} [{card_line}]")
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        pool.shutdown()

    # every pooled chunk with host syncs raising (serializes admission behind decoding)
    pool = ContinuousBatcher(eng, pool_size=8, chunk_len=16, kv_bucket=eng.kv_ladder[0],
                             sync_check=True)
    try:
        handle = pool.submit_stream("hello world", language="en", max_tokens=32, seed=5)
        futs = [pool.submit(t, language=lang, max_tokens=32) for t, lang, _, _ in POOL_REQUESTS[:4]]
        list(handle)
        for f in futs:
            f.result(timeout=600)
        log(f"pool with sync_check: {pool.stats['chunks']} chunks, no host sync inside a chunk")
    finally:
        pool.shutdown()
    return [sum(c) for c in zip(*counts)]


SOAK_REQUESTS = 40  # the CPU soak's schedule (tests/test_torch_pool_soak.py), cut from 200
SOAK_TEXTS = ["hello", "hello world", "abc", "one two three"]
SOAK_LANGS = ["auto", "en", "zh", "ja"]
SOAK_SEEDS = [1, 2, 3]  # few, so that keys repeat


def soak_consume(item, first):
    """One soak request's result: a rejection's error, or finite audio of at
    most max_tokens frames (a stream's chunks equal to the retired audio
    within 2e-4) whose codes equal every earlier request's of its key."""
    key, kind, handle = item
    if kind == "reject":
        try:
            handle.result(timeout=600)
        except EngineError as e:  # the admission's refusal
            if "too long" not in str(e):
                raise
            return
        raise RuntimeError("soak: an overlong text was admitted")
    if kind == "stream":
        items = list(handle)
        result = items[-1]
        streamed = np.concatenate(items[:-1]) if len(items) > 1 else np.zeros(0, np.float32)
        if (streamed.shape != result.audio.shape
                or not np.allclose(streamed, result.audio, rtol=0, atol=2e-4)):
            raise RuntimeError(f"soak: streamed chunks differ from the retired audio for {key}")
    else:
        result = handle.result(timeout=600)
    if result.codes.shape[0] > key[3] or not np.isfinite(result.audio).all():
        raise RuntimeError(f"soak: bad result for {key}")
    if key in first and not np.array_equal(result.codes, first[key]):
        raise RuntimeError(f"soak: occupancy-dependent output for {key}")
    first.setdefault(key, np.asarray(result.codes))


def pool_soak(eng, card_line):
    """The CPU soak's schedule (the JAX package's tests/test_pool_soak.py) on
    an 8-slot pool of ``eng``: SOAK_REQUESTS requests from
    ``random.Random(0xC0FFEE)``, ~6% overlong texts rejected at admission,
    ~20% streamed, greedy or temperature 0.8, max_tokens 1-6, three seeds,
    drained as they go at a varying depth.  Every repeat of a key (text,
    language, temperature, max_tokens, seed) decodes its codes again
    whatever shares the pool, the queue drains, ``stats`` counts the
    admitted requests; one K4 and one K5 per pooled frame, one K1 and one K2
    per streamed request's bootstrap, no launch-per-op entry."""
    rng = random.Random(0xC0FFEE)
    first, pending = {}, []
    rejected = streamed = 0
    t0 = time.perf_counter()
    reset_launches()
    pool = ContinuousBatcher(eng, pool_size=8, chunk_len=2, kv_bucket=eng.kv_ladder[0],
                             text_bucket_max=16)
    try:
        for _ in range(SOAK_REQUESTS):
            if rng.random() < 0.06:
                pending.append((None, "reject", pool.submit("hello " * 40, temperature=0.0)))
                rejected += 1
            else:
                text, lang = rng.choice(SOAK_TEXTS), rng.choice(SOAK_LANGS)
                temp = 0.0 if rng.random() < 0.5 else 0.8
                mt, seed = rng.randint(1, 6), rng.choice(SOAK_SEEDS)
                key = (text, lang, temp, mt, seed)
                kw = dict(language=lang, temperature=temp, max_tokens=mt, seed=seed)
                if rng.random() < 0.2:
                    pending.append((key, "stream", pool.submit_stream(text, **kw)))
                    streamed += 1
                else:
                    pending.append((key, "future", pool.submit(text, **kw)))
            while len(pending) > rng.randint(4, 12):
                soak_consume(pending.pop(0), first)
        while pending:
            soak_consume(pending.pop(0), first)
        deadline = time.time() + 60
        while pool.stats["active"] or pool.stats["queued"]:
            if time.time() > deadline:
                raise RuntimeError(f"soak: the pool did not drain: {pool.stats}")
            time.sleep(0.02)
        st = pool.stats
    finally:
        pool.shutdown()
    if st["requests"] != SOAK_REQUESTS - rejected or not rejected or len(first) < 10:
        raise RuntimeError(f"soak: {st['requests']} requests done of {SOAK_REQUESTS} with "
                           f"{rejected} rejected, {len(first)} keys")
    counts = check_launches(f"soak ({streamed} streamed bootstraps, {st['chunks']} chunks of 2)",
                            counts_of(K1=streamed, K2=streamed, K4=2 * st["chunks"],
                                      K5=2 * st["chunks"]))
    log(f"pool soak: {SOAK_REQUESTS} requests ({rejected} rejected, {streamed} streamed, "
        f"{len(first)} keys, each repeat equal to its first) through 8 slots in "
        f"{time.perf_counter() - t0:.1f} s, drained [{card_line}]")
    return counts


SPEC_K, SPEC_ITERS = 4, 4  # the engine's spec phase (B=1 and synthesize_batch at B=4)
POOL_SPEC_K, POOL_SPEC_ITERS = 3, 2  # the spec pool: 8 slots x 3 candidates = 24 verify rows
SPEC_TEXT = "hello world, this is a speculative request"


def greedy_trajectory(eng, text, n_frames):
    """``n_frames`` greedy frames of one stream, EOS forbidden, through the
    sequential generate callables (K1, K2): the replay draft's trajectory."""
    sp = SamplingParams.create(0.0, forbid_eos=True)
    ids = eng._tokenize(text)
    P = prompt_length(LANG_ENGLISH)
    bucket = next(b for b in eng.kv_ladder if b >= P + n_frames + 1)
    fns = eng._get_fns(LANG_ENGLISH, bucket, n_frames, 1)
    state, bundle = fns.prefill(eng.params, torch.tensor([ids], device=DEV),
                                torch.tensor([len(ids)], device=DEV), None)
    _, frames, _ = fns.decode(eng.params, state, bundle.trailing, bundle.trailing_len,
                              bundle.tts_pad_embed, sp)
    return frames[0].cpu()


def spec_fixed_run(eng, n_frames, sp, texts, draft_fn, force_accept=False, k=SPEC_K,
                   iters=SPEC_ITERS):
    """Speculative decode of len(texts) streams until each has committed at
    least ``n_frames`` frames, through the spec callables and the engine's
    cache growth, with any host sync inside a dispatch raising.  Returns
    (committed frames per stream, iterations run, decode seconds, frames the
    dispatches committed)."""
    B = len(texts)
    id_lists = [eng._tokenize(t) for t in texts]
    width = max(len(ids) for ids in id_lists)
    ids_t = torch.tensor([ids + [0] * (width - len(ids)) for ids in id_lists], device=DEV)
    lens = torch.tensor([len(ids) for ids in id_lists], device=DEV)
    P = prompt_length(LANG_ENGLISH)
    ladder = eng.kv_ladder
    bidx = next(i for i, b in enumerate(ladder) if b >= P + k * iters + 1)
    gens = []
    for b in range(B):
        gens.append(torch.Generator(device=DEV))
        gens[-1].manual_seed(SEED + b)

    def fns():
        return make_spec_generate_fns(eng.cfg, max_len=ladder[bidx], k=k, num_iters=iters,
                                      batch=B, lang_id=LANG_ENGLISH, draft_fn=draft_fn,
                                      force_accept=force_accept)

    state, bundle, f0, v0 = fns().prefill(eng.params, ids_t, lens, gens, sp)
    committed = [[f] for f in f0.cpu()]
    iterations, decode_s, decoded = 0, 0.0, 0
    while min(len(c) for c in committed) < n_frames:
        slots = int(state.step.max())
        while P + slots - 1 + k * iters + 1 > ladder[bidx] and bidx + 1 < len(ladder):
            bidx += 1
            state = eng._grow_state(state, ladder[bidx])
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the dispatch raises
        try:
            state, fr, vd = fns().decode(eng.params, state, bundle.trailing, bundle.trailing_len,
                                         bundle.tts_pad_embed, sp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fr, vd = fr.cpu(), vd.cpu()
        decode_s += time.perf_counter() - t0
        for b in range(B):
            committed[b].extend(fr[b][vd[b]])
        decoded += int(vd.sum())
        iterations += iters
    return [torch.stack(c) for c in committed], iterations, decode_s, decoded


def profile_spec_dispatch(eng, sp, card_line):
    """Device time by kernel over one B=1 spec dispatch (k=4, 4 iterations,
    repeat draft, after a warm one), from ``torch.profiler``: the device
    busy time per iteration against the wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    fns = make_spec_generate_fns(eng.cfg, max_len=512, k=SPEC_K, num_iters=SPEC_ITERS, batch=1,
                                 lang_id=LANG_ENGLISH)
    ids = eng._tokenize(SPEC_TEXT)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    state, bundle, _, _ = fns.prefill(eng.params, torch.tensor([ids], device=DEV),
                                      torch.tensor([len(ids)], device=DEV), gen, sp)

    def dispatch(st):
        return fns.decode(eng.params, st, bundle.trailing, bundle.trailing_len,
                          bundle.tts_pad_embed, sp)[0]

    state = dispatch(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"spec dispatch profile B=1 k={SPEC_K}, {SPEC_ITERS} iterations: wall {wall_ms:.2f} ms "
        f"({wall_ms / SPEC_ITERS:.2f} per iteration, profiler on), device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kernels)} device ops; "
        f"top: " + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                             for e in top) + f" [{card_line}]")


def check_spec_engine(name, seq_eng, spec_eng, card_line, want_fallback=False):
    """Greedy ``synthesize`` of the spec engine against the sequential one:
    codes equal; launches one K6 and one K5 per verify iteration, K2 for
    frame 0, and K1 / K2 per frame after a fallback."""
    kw = dict(language="en", temperature=0.0, max_tokens=64)
    want = seq_eng.synthesize(SPEC_TEXT, **kw)
    reset_launches()
    got = spec_eng.synthesize(SPEC_TEXT, **kw)
    m = got.metrics
    n_it, k = m.spec_iterations, spec_eng.spec_k
    seq_frames = m.decoded_frames - 1 - n_it * k  # decoded after a fallback
    counts = check_launches(f"spec {name}", (seq_frames + m.spec_fallback, 1 + seq_frames, 0,
                                             n_it, n_it))
    equal = np.array_equal(got.codes, want.codes)
    log(f"spec {name}: {len(got.codes)} frames, codes equal to sequential={equal}, "
        f"{n_it} iterations, acceptance {m.spec_accepted / max(n_it * (k - 1), 1):.3f}, "
        f"fallback={m.spec_fallback}, "
        f"{m.stage_seconds['decode'] * 1e3 / max(len(got.codes), 1):.3f} ms per committed "
        f"frame decode, RTF {m.rtf:.2f}x, TTFA {m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
    if not equal or m.spec_fallback != want_fallback or n_it < 1:
        raise RuntimeError(f"spec {name}: codes differ from sequential or the fallback misfired")
    return counts


def spec_phase(eng, spec_eng, draft_eng, seq_ms, card_line):
    """The speculative paths at the 0.6B preset: B=1 greedy with the repeat
    draft, the adaptive fallback and the trained draft against sequential;
    the replay draft at full acceptance; ms per committed frame at full and
    at zero acceptance; synthesize_batch at B=4; the spec pool."""
    counts = [check_spec_engine("B=1 repeat draft", eng, spec_eng, card_line)]
    spec_eng.spec_accept_floor, spec_eng.spec_adapt_window = 1.01, 1
    try:
        counts.append(check_spec_engine("B=1 adaptive fallback", eng, spec_eng, card_line, True))
    finally:
        spec_eng.spec_accept_floor, spec_eng.spec_adapt_window = 0.0, 24
    counts.append(check_spec_engine("B=1 trained draft", eng, draft_eng, card_line))

    # replay draft: full acceptance by construction, codes equal the trajectory
    traj = greedy_trajectory(eng, SPEC_TEXT, 1 + 3 * SPEC_ITERS * SPEC_K + SPEC_K)
    reset_launches()
    greedy = SamplingParams.create(0.0, forbid_eos=True)
    frames, it, _, decoded = spec_fixed_run(eng, 1 + 3 * SPEC_ITERS * SPEC_K, greedy, [SPEC_TEXT],
                                            make_replay_draft(traj.to(DEV)))
    counts.append(check_launches("spec replay draft", (0, 1, 0, it, it)))
    equal = torch.equal(frames[0], traj[: len(frames[0])])
    log(f"spec replay draft: {it} iterations committed {decoded} frames ({SPEC_K} per "
        f"iteration: {decoded == it * SPEC_K}), codes equal to the sequential trajectory={equal}")
    if not equal or decoded != it * SPEC_K:
        raise RuntimeError("spec replay draft: not full acceptance, or codes differ")

    # ms per committed frame, sampled, EOS forbidden: full and zero acceptance
    sampled = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    ms = {}
    for label, draft_fn, force in (("full acceptance (force_accept)", repeat_draft, True),
                                   ("repeat draft", repeat_draft, False)):
        reset_launches()
        _, it, decode_s, decoded = spec_fixed_run(eng, FIXED_FRAMES, sampled, [SPEC_TEXT],
                                                  draft_fn, force)
        counts.append(check_launches(f"spec fixed run, {label}", (0, 1, 0, it, it)))
        ms[label] = decode_s * 1e3 / decoded
        log(f"spec fixed run B=1 k={SPEC_K}, {label}: {decoded} frames in {it} iterations "
            f"(acceptance {(decoded - it) / (it * (SPEC_K - 1)):.3f}), {ms[label]:.3f} ms per "
            f"committed frame, {decode_s * 1e3 / it:.3f} ms per iteration; sequential "
            f"{seq_ms:.3f} ms/frame [{card_line}]")

    profile_spec_dispatch(eng, sampled, card_line)

    # synthesize_batch at B=4
    texts = BATCH_TEXTS[:4]
    kw = dict(language="en", temperature=0.0, max_tokens=48)
    want = eng.synthesize_batch(texts, **kw)
    reset_launches()
    t0 = time.perf_counter()
    got = spec_eng.synthesize_batch(texts, **kw)
    wall = time.perf_counter() - t0
    n_it = got[0].metrics.spec_iterations
    counts.append(check_launches("spec synthesize_batch B=4", (0, 0, 0, 1 + n_it, n_it)))
    equal = all(np.array_equal(g.codes, w.codes) for g, w in zip(got, want))
    log(f"spec synthesize_batch B=4 k={SPEC_K}: frames {[len(g.codes) for g in got]}, per-stream "
        f"codes equal to sequential synthesize_batch={equal}, {n_it} iterations, aggregate RTF "
        f"{sum(g.metrics.audio_seconds for g in got) / wall:.2f}x [{card_line}]")
    if not equal:
        raise RuntimeError("spec synthesize_batch differs from sequential synthesize_batch")
    counts += spec_pool_phase(eng, spec_eng, card_line)
    return [sum(c) for c in zip(*counts)], ms


def spec_pool_phase(eng, spec_eng, card_line):
    """12 requests through an 8-slot spec pool; greedy output against B=1
    synthesize, a seeded request alone and among co-tenants; then a spec
    pool with host syncs raising inside every chunk, whose fallback fires."""
    pool = ContinuousBatcher(spec_eng, pool_size=8, kv_bucket=eng.kv_ladder[0],
                             spec_k=POOL_SPEC_K, spec_iters=POOL_SPEC_ITERS)
    per_chunk = POOL_SPEC_ITERS
    try:
        reset_launches()
        t0 = time.perf_counter()
        handle = pool.submit_stream(STREAMED_REQUEST[0], language=STREAMED_REQUEST[1],
                                    temperature=STREAMED_REQUEST[2][0],
                                    max_tokens=STREAMED_REQUEST[3], seed=SEED)
        futs = [pool.submit(text, language=lang, temperature=k[0], top_k=k[1], top_p=k[2],
                            max_tokens=mt, seed=SEED + i)
                for i, (text, lang, k, mt) in enumerate(POOL_REQUESTS)]
        items = list(handle)
        results = [f.result(timeout=600) for f in futs] + [items[-1]]
        wall = time.perf_counter() - t0
        for r in results:
            if (r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,)
                    or not np.isfinite(r.audio).all() or len(r.codes) == 0):
                raise RuntimeError("spec pool: bad result")
        chunks = pool.stats["chunks"]
        audio_s = sum(r.metrics.audio_seconds for r in results)
        log(f"spec pool k={POOL_SPEC_K}: 12 requests through 8 slots in {wall:.2f} s, {chunks} "
            f"chunks of {POOL_SPEC_ITERS} iterations, aggregate RTF {audio_s / wall:.2f}x, "
            f"streamed TTFA {items[-1].metrics.ttfa_seconds * 1e3:.1f} ms, spec_fallback="
            f"{pool.stats['spec_fallback']} [{card_line}]")
        counts = [check_launches("spec pool", (0, 12, 0, chunks * per_chunk, chunks * per_chunk))]

        reset_launches()
        chunks0 = pool.stats["chunks"]
        text = "hello world, greedy through the spec pool"
        got = pool.synthesize(text, language="en", temperature=0.0, max_tokens=48)
        n = (pool.stats["chunks"] - chunks0) * per_chunk
        counts.append(check_launches("spec pool greedy", (0, 1, 0, n, n)))
        want = eng.synthesize(text, language="en", temperature=0.0, max_tokens=48)
        equal = np.array_equal(got.codes, want.codes)
        log(f"spec pool greedy vs synthesize at B=1: {len(got.codes)} frames, codes equal={equal}")
        if not equal:
            raise RuntimeError("spec pool greedy output differs from synthesize at B=1")
        kw = dict(language="en", temperature=0.8, top_k=50, top_p=0.95, max_tokens=16, seed=123)
        alone = pool.synthesize("hello world, seeded", **kw)
        mates = [pool.submit(t, language=lang, temperature=0.9, max_tokens=16)
                 for t, lang, _, _ in POOL_REQUESTS[:6]]
        among = pool.submit("hello world, seeded", **kw)
        for f in mates:
            f.result(timeout=600)
        equal = np.array_equal(among.result(timeout=600).codes, alone.codes)
        log(f"spec pool seeded request alone vs among 6 co-tenants: codes equal={equal}")
        if not equal:
            raise RuntimeError("a seeded spec-pool request depends on its co-tenants")
    finally:
        pool.shutdown()

    spec_eng.spec_accept_floor, spec_eng.spec_adapt_window = 1.01, 1
    pool = ContinuousBatcher(spec_eng, pool_size=8, kv_bucket=eng.kv_ladder[0],
                             spec_k=POOL_SPEC_K, spec_iters=POOL_SPEC_ITERS, sync_check=True)
    try:
        handle = pool.submit_stream("hello world", language="en", max_tokens=32, seed=5)
        futs = [pool.submit(t, language=lang, max_tokens=32) for t, lang, _, _ in POOL_REQUESTS[:4]]
        list(handle)
        for f in futs:
            f.result(timeout=600)
        fell_back = pool.stats["spec_fallback"]
        log(f"spec pool with sync_check: {pool.stats['chunks']} chunks, no host sync inside a "
            f"chunk, spec_fallback={fell_back} (floor 1.01)")
        if not fell_back:
            raise RuntimeError("the spec pool's adaptive fallback did not fire")
    finally:
        pool.shutdown()
        spec_eng.spec_accept_floor, spec_eng.spec_adapt_window = 0.0, 24
    return counts


def check_k3_equals_k2(cp, fw, heads, tables, fnorm, gen, iters, inputs=K3_EQUAL_INPUTS):
    """The persistent K3 on ``inputs`` seeded inputs (knobs cycling through
    K5_KNOBS) against its launch-per-op chain (``k3_multi``, int8 units and
    heads only) and against K2 with a float32 cache: sub-codes and sub_sum
    equal bit for bit.  With
    ``iters``, K3 timed in turns with the launch-per-op chain (old, new, new,
    old) and with K2 at a float32 cache, and traced once.  Returns (K3 ms,
    K2 float32-cache ms)."""
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    t = cp.transformer
    multi = fw.wqkv.dtype == torch.int8 and heads.q.dtype == torch.int8
    equal = 0
    for i in range(inputs):
        temp, top_k, top_p = K5_KNOBS[i % len(K5_KNOBS)]
        lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        args = (t, fw, fnorm, heads, tables, lh, c0, gumbel_noise((n, 1, V), gen, DEV), temp,
                top_k, top_p)
        s3, sum3 = K3.fused_mtp_chain_streamed(*args)
        so, sum_o = k3_multi(*args) if multi else (s3, sum3)
        s2, sum2 = K2.fused_mtp_chain(*args, cache_dtype=torch.float32)
        same = [bool(torch.equal(s3, so)) and bool(torch.equal(sum3, sum_o)),
                bool(torch.equal(s3, s2)) and bool(torch.equal(sum3, sum2))]
        if not all(same):
            log(f"K3 input {i} knobs {(temp, top_k, top_p)}: equal to the launch-per-op chain "
                f"{same[0]}, to K2 (float32 cache) {same[1]}")
        equal += all(same)
    ok = equal == inputs
    units = f"{K1.names_of(fw)} trunk, {str(heads.q.dtype)[6:]} heads"
    log(f"K3 vs {'its launch-per-op chain and ' if multi else ''}K2 (float32 cache), {units}, "
        f"H={t.hidden_size}: {equal}/{inputs} seeded chains equal bit for bit (sub-codes, "
        f"sub_sum; knobs {K5_KNOBS}) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError("K3 differs from its launch-per-op chain or from K2 with a float32 cache")
    if not iters:
        return float("nan"), float("nan")
    args = args[:8] + K5_KNOBS[1]

    def k2():
        return K2.fused_mtp_chain(*args, cache_dtype=torch.float32)

    def k3():
        return K3.fused_mtp_chain_streamed(*args)

    k3_ms, _ = in_turns(f"K3 {t.hidden_size}-wide sampled {K5_KNOBS[1]}", lambda: k3_multi(*args),
                        k3, iters)
    k2_ms = time_ms(k2, iters)
    log(f"K3 {k3_ms:.4f} ms/chain, K2 float32 cache {k2_ms:.4f} ms/chain (the same kernel on "
        f"another plan entry) [{CARD}]")
    trace_phases(f"K3 {t.hidden_size}-wide sampled {K5_KNOBS[1]}",
                 K2._chain_entry("qtts_mtp_chain_streamed", t, fw, heads, tables, torch.float32,
                                 args[5].device).plan, chain_phase_names(t.num_layers, n), k3)
    return k3_ms, k2_ms


def k8_case(B, S, T, nq, nk, kind, dtype, gen, d=128):
    """Seeded q [B, S, nq, d], k and v [B, nk, T, d] and a mask [B, S, T].
    kind "prefill": query i at position i over a T-slot bucket (the engine's
    prefill); "random": queries at T-S..T-1, batch b's keys valid below a
    random length, and batch 0's first row masked everywhere; "dead rows":
    "random" with batch 0's rows 0, 2 and S - 1 masked everywhere; "last
    tile": every row allows the keys of the last 64-key tile only;
    "teacher": the draft trainer's teacher pass, query i at position i
    (S = T) and batch b's keys valid below a random length in [T/2, T] (its
    right-padded frames masked as keys)."""
    q = torch.randn((B, S, nq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((B, nk, T, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((B, nk, T, d), generator=gen, device=DEV).to(dtype)
    slots = torch.arange(T, device=DEV)
    if kind == "prefill":
        mask = slots[None, None, :] <= torch.arange(S, device=DEV)[None, :, None]
        return q, k, v, mask.expand(B, S, T).contiguous()
    if kind == "last tile":
        mask = slots[None, None, :] >= (T - 1) // 64 * 64
        return q, k, v, mask.expand(B, S, T).contiguous()
    qpos = torch.arange(S, device=DEV) + (T - S)
    valid = torch.randint(T // 2, T + 1, (B,), generator=gen, device=DEV)
    if kind == "teacher":
        mask = (slots[None, None, :] <= qpos[None, :, None]) & (slots < valid[:, None])[:, None]
        return q, k, v, mask.contiguous()
    mask = (slots[None, None, :] <= qpos[None, :, None]) & (slots[None, None, :] < valid[:, None, None])
    mask[0, 0] = False
    if kind == "dead rows":
        mask[0, [0, min(2, S - 1), S - 1]] = False
    return q, k, v, mask.contiguous()


def attn_bound(q, k, mask):
    """Least time of one attention call on this data: q, the mask and the
    output, and the k and v rows some query attends to, moved once; 4 d
    operations per (q head, attended key)."""
    d, nq, nk = q.shape[3], q.shape[2], k.shape[1]
    rows = int(mask.any(dim=1).sum()) * nk  # kv rows read, over the batch and kv heads
    moved = 2 * nbytes([q]) + nbytes([mask]) + 2 * rows * d * k.element_size()
    return bound(moved, 4 * d * nq * int(mask.sum()))


def check_k8(name, B, S, T, nq, nk, kind, gen, iters=0, d=128):
    """K8 against its plain version on one seeded case in float32 (within
    K8_F32_ABS) and in bf16 (within K8_BF16_REL of the largest output, and
    at most K8_BF16_FLIPS of the outputs differing at all); the rows that
    allow no key against sum_{t<T} v_t / Tp in both.  With ``iters``, the
    bf16 case is timed beside its plain version and
    ``scaled_dot_product_attention`` on the same inputs (k and v repeated to
    the q heads first, outside the timing), and its device time per call is
    read from the profiler.  Returns (bf16 max_abs_err, ms, plain ms,
    library ms, bound)."""
    res = {}
    Tp = K8.padded_keys(T)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = k8_case(B, S, T, nq, nk, kind, dtype, gen, d)
        out = K8.flash_attend(q, k, v, mask)
        ref = K8.flash_attend_reference(q, k, v, mask)
        dead = ~mask.any(dim=-1)  # [B, S]
        closed = (v.float().sum(dim=2) / Tp).repeat_interleave(nq // nk, dim=1)  # [B, nq, D]
        closed = closed[:, None].expand(B, S, nq, -1)[dead]
        torch.cuda.synchronize()
        res[dtype] = (float((out.float() - ref.float()).abs().max()), float(ref.float().abs().max()),
                      bool(torch.isfinite(out.float()).all()), int((out != ref).sum()),
                      float((out.float()[dead] - closed).abs().max()) if dead.any() else 0.0,
                      int(dead.sum()))
    (e32, _, fin32, _, c32, n_dead), (e16, m16, fin16, flips, c16, _) = (
        res[torch.float32], res[torch.bfloat16])
    n_out = B * S * nq * d
    ok = (fin32 and fin16 and e32 <= K8_F32_ABS and e16 <= K8_BF16_REL * m16
          and flips <= K8_BF16_FLIPS * n_out and c32 <= K8_F32_ABS and c16 <= K8_BF16_REL * m16)
    ms = plain_ms = lib_ms = dev_ms = float("nan")
    if iters:
        ms = time_ms(lambda: K8.flash_attend(q, k, v, mask), iters)
        dev_ms = device_ms(lambda: K8.flash_attend(q, k, v, mask), iters)
        plain_ms = time_ms(lambda: K8.flash_attend_reference(q, k, v, mask), 5, 1)
        g = nq // nk
        qh, kh, vh = q.transpose(1, 2), k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        am = mask[:, None]
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=am), iters)
    masked = "" if not n_dead else (
        f"; {n_dead} rows allow no key: max |out - sum v / {Tp}| float32 {c32:.3e}, bf16 "
        f"{c16:.3e}")
    b_ms, b_by = attn_bound(q, k, mask)
    log(f"K8 {name} ({kind}): B={B} S={S} T={T} nq={nq} nk={nk} d={d} float32 "
        f"max_abs_err={e32:.3e} (tol "
        f"{K8_F32_ABS}) bf16 max_abs_err={e16:.3e} (tol {K8_BF16_REL * m16:.3e}), bf16 outputs "
        f"differing {flips}/{n_out} (limit {K8_BF16_FLIPS * n_out:.0f}){masked}; kernel "
        f"{ms:.4f} ms (device {dev_ms * 1e3:.2f} us per call, profiler) plain {plain_ms:.4f} ms "
        f"sdpa {lib_ms:.4f} ms bound {b_ms * 1e3:.3f} us "
        f"({b_by}) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K8 {name} disagrees with its plain version")
    return e16, ms, plain_ms, lib_ms, (b_ms, b_by)


# The entry points (phase 10): a checkpoint directory, the CLI in process, the
# speaker embedding, the server as a subprocess, a profile
ENTRY_TEXT = "hello world, this is the command line"
CLI_FRAMES = 48
# the speaker embedding on the card against the same checkpoint on the CPU:
# the two log-mels are float32 FFTs rounded differently (cuFFT and
# PocketFFT), which moves a random 0.6B-width encoder's embedding by 2e-7 of
# its largest value on noise-like audio, 2.3e-5 on a 16-bit tone and 3.3e-4
# on a pure tone, whose bins lie at the FFT's rounding floor (two CPU FFTs,
# XLA's and PocketFFT's); matmuls in float32 on both (TF32 off)
SPK_REL = 1e-3
SERVE_START_S = 600  # the server subprocess: load, build the engine, warm up
SERVE_STOP_S = 120  # ... and exit 0 after SIGINT
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
SUMMARY = re.compile(r"decode ([\d.]+)ms.*; (\d+) frames decoded"
                     r"(?:; spec (\d+) iterations, (\d+) accepted(, fallback)?)?\)")


def same_checkpoint(a: dict, b: dict) -> bool:
    """Every leaf of ``a`` and ``b`` by key: the same dtype, shape and bytes."""
    fa, fb = flatten_params(a), flatten_params(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype.str == fb[k].dtype.str and fa[k].shape == fb[k].shape
        and np.array_equal(fa[k].view(np.uint8), fb[k].view(np.uint8)) for k in fa)


def run_cli(argv):
    """``cli.main(argv)`` in this process (so that the launch counters see
    its kernels): (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue(), err.getvalue()


def check_wav(path_or_bytes, label):
    """A mono 16-bit 24 kHz WAV of whole frames; returns its samples."""
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with wave.open(src) as w:
        fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), "<i2")
    if fmt != (1, 2, 24000) or n == 0 or n % SAMPLES_PER_FRAME:
        raise RuntimeError(f"{label}: not a mono 16-bit 24 kHz WAV of whole frames: {fmt}, {n}")
    return pcm


def cli_phase(d, tmp, card_line):
    """The CLI on the checkpoint, in process: one-shot, --frame-fused on,
    --stream, --ref, --spec-k 4 (int8), one-shot without --quantize (bf16
    units: one K1 and one K3 per frame), --quantize int8 --kv-quant and
    --kv-quant alone (the int8 KV cache), --spec-k 4 with --quantize int4
    and with an unset --quantize beside --mtp-quantize int4 (the precision
    phase drives the other precision flags).  Returns (int8 launch counts, ms per frame of the int8 one-shot
    run, reference WAV, bf16 launch counts, ms per frame of the bf16 run,
    int8-KV-cache launch counts, the two spec runs' launch counts by flags)."""
    base = ["-m", d, "-p", ENTRY_TEXT, "--lang", "en", "--temp", "0", "--max-tokens",
            str(CLI_FRAMES), "--quantize", "int8", "--verbose"]
    unquantized = [a for a in base if a not in ("--quantize", "int8")]
    ref = os.path.join(tmp, "ref.wav")
    counts, ms_frame, bf16_counts, bf16_ms, kvq_counts = [], None, [], None, []
    spec_counts = {}
    for label, extra in (("one-shot", []), ("--frame-fused on", ["--frame-fused", "on"]),
                         ("--stream", ["--stream"]), ("--ref", ["--ref", ref]),
                         ("--spec-k 4", ["--spec-k", "4"]), ("without --quantize", None),
                         ("--quantize int8 --kv-quant", ["--kv-quant"]),
                         ("--kv-quant without --quantize", ["--kv-quant", None])):
        out_wav = os.path.join(tmp, f"cli-{len(counts) + len(bf16_counts) + len(kvq_counts)}.wav")
        reset_launches()
        t0 = time.perf_counter()
        kvq = extra is not None and "--kv-quant" in extra
        if extra is not None and None in extra:  # unquantized, with the flags before None
            argv = unquantized + ["-o", out_wav] + extra[:-1]
        else:
            argv = (base + ["-o", out_wav] + extra if extra is not None
                    else unquantized + ["-o", out_wav])
        rc, out, err = run_cli(argv)
        wall = time.perf_counter() - t0
        m = SUMMARY.search(out)
        if rc != 0 or m is None:
            raise RuntimeError(f"CLI {label}: exit {rc}\n{out}\n{err}")
        decode_ms, n = float(m.group(1)), int(m.group(2))
        if extra is None or None in extra:  # bf16 units: the streamed chain K3 at B=1
            want = counts_of(K1=n, K3=n)
        elif extra == ["--frame-fused", "on"]:
            want = (0, 0, 0, 0, 0, 0, 0, n)
        elif m.group(3) is not None:
            it, fallback = int(m.group(3)), m.group(5) is not None
            seq = n - 1 - it * 4  # frames decoded after a fallback
            want = (seq + fallback, 1 + seq, 0, it, it)
        else:
            want = (n, n)
        (kvq_counts if kvq else counts if extra is not None else bf16_counts).append(
            check_launches(f"CLI {label} ({n} frames decoded)", want))
        pcm = check_wav(out_wav, f"CLI {label}")
        log(f"CLI {label}: exit 0, {pcm.size / 24000:.2f} s of audio, {n} frames decoded, "
            f"{decode_ms / n:.3f} ms/frame decode, {wall:.2f} s of wall time (checkpoint load, "
            f"engine build, synthesis, WAV) [{card_line}]")
        if label == "one-shot":
            ms_frame = decode_ms / n
            # a 3 s reference for --ref, from this run's audio
            write_wav(ref, np.resize(pcm.astype(np.float32) / 32768.0, 3 * 24000), 24000)
        if extra is None:
            bf16_ms = decode_ms / n
    # int4 units, and an int4 MTP trunk beside an unquantized talker, under
    # --spec-k (K6 int4 / bf16, K5 int4)
    int4 = [a if a != "int8" else "int4" for a in base]
    for label, argv in (("--quantize int4 --spec-k 4", int4 + ["--spec-k", "4"]),
                        ("without --quantize, --mtp-quantize int4 --spec-k 4",
                         unquantized + ["--mtp-quantize", "int4", "--spec-k", "4"])):
        out_wav = os.path.join(tmp, f"cli-spec-{len(spec_counts)}.wav")
        reset_launches()
        rc, out, err = run_cli(argv + ["-o", out_wav])
        m = SUMMARY.search(out)
        if rc != 0 or m is None or m.group(3) is None:
            raise RuntimeError(f"CLI {label}: exit {rc}\n{out}\n{err}")
        n, it, fallback = int(m.group(2)), int(m.group(3)), m.group(5) is not None
        seq = n - 1 - it * 4
        spec_counts[label] = check_launches(f"CLI {label} ({n} frames decoded)",
                                            counts_of(K1=seq + fallback, K2=1 + seq, K5=it, K6=it))
        pcm = check_wav(out_wav, f"CLI {label}")
        log(f"CLI {label}: exit 0, {pcm.size / 24000:.2f} s of audio, {n} frames decoded, "
            f"{it} verify iterations [{card_line}]")
    return ([sum(c) for c in zip(*counts)], ms_frame, ref, [sum(c) for c in zip(*bf16_counts)],
            bf16_ms, [sum(c) for c in zip(*kvq_counts)], spec_counts)


def start_servers(d, flag_sets):
    """``python -m leaxer_qwen3_tts_torch.serve`` as one subprocess per flag
    set (``(quantize, extra)``: ``--quantize quantize``, or none: bf16 units;
    then the ``extra`` flags), all started at once, so that their boots
    overlap (each one's seconds to serve are then under that contention);
    ``finish_servers`` waits for each one's warmup, sends two requests (one
    streamed) and checks its exit 0 on SIGINT."""
    servers = []
    try:
        for quantize, extra in flag_sets:
            cmd = [sys.executable, "-m", "leaxer_qwen3_tts_torch.serve", "-m", d,
                   *(["--quantize", quantize] if quantize else []), *extra, "--max-tokens",
                   "128", "--port", "0"]
            proc = subprocess.Popen(cmd, cwd=REPO_DIR, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            # each line with the moment it came (a server is read only once
            # the ones before it are done)
            lines: "queue.Queue[tuple]" = queue.Queue()
            reader = threading.Thread(
                target=lambda p=proc, q=lines: [q.put((time.perf_counter(), x)) for x in p.stdout]
                + [q.put((time.perf_counter(), ""))], daemon=True)
            reader.start()
            servers.append((quantize, extra, proc, lines, reader, time.perf_counter()))
    except BaseException:
        finish_servers(servers, None, kill=True)
        raise
    return servers


def finish_servers(servers, card_line, kill=False):
    """The requests to started servers (``kill``: stop them, nothing else);
    every server is stopped on the way out, whatever failed.  Returns their
    warmup seconds."""
    try:
        return [] if kill else [_serve(*s, card_line, len(servers)) for s in servers]
    finally:
        for _, _, proc, *_ in servers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _serve(quantize, extra, proc, lines, reader, t0, card_line, booted):
    """One started server: wait for its "serving on" line, send its
    requests, stop it.  Returns its warmup seconds."""
    seen, port, warm_s = [], None, None
    deadline = t0 + SERVE_START_S
    while port is None:
        try:
            stamp, line = lines.get(timeout=max(deadline - time.perf_counter(), 0.1))
        except queue.Empty:
            raise RuntimeError(f"server: no 'serving on' line in {SERVE_START_S} s:\n"
                               + "".join(seen)) from None
        if not line:
            raise RuntimeError(f"server exited ({proc.wait()}) before serving:\n" + "".join(seen))
        seen.append(line)
        if line.startswith("warmup done in "):
            warm_s = float(line.split()[3].rstrip("s"))
        m = re.match(r"serving on http://127\.0\.0\.1:(\d+) ", line)
        if m:
            port = int(m.group(1))
    started_s = stamp - t0
    body = json.dumps({"text": ENTRY_TEXT, "language": "en", "temperature": 0.0,
                       "max_tokens": 48}).encode()
    for path in ("/synthesize", "/synthesize_stream"):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                     headers={"Content-Type": "application/json"})
        t1 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            status, kind, data = r.status, r.headers["Content-Type"], r.read()
        if path == "/synthesize":
            n = check_wav(data, "server /synthesize").size
        elif not kind.startswith("audio/L16") or not data or len(data) % 2:
            raise RuntimeError(f"server {path}: {kind}, {len(data)} bytes")
        else:
            n = len(data) // 2
        if status != 200:
            raise RuntimeError(f"server {path}: HTTP {status}")
        log(f"server {path}: HTTP 200, {kind}, {n / 24000:.2f} s of audio in "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms [{card_line}]")
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=SERVE_STOP_S)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"server: still running {SERVE_STOP_S} s after SIGINT") from None
    if rc != 0:
        raise RuntimeError(f"server: exit {rc} after SIGINT:\n" + "".join(seen))
    reader.join(timeout=10)
    log(f"server subprocess ({'--quantize ' + quantize if quantize else 'no --quantize: bf16 units'}"
        f"{''.join(' ' + f for f in extra)}): serving {started_s:.1f} s after start (checkpoint "
        f"load, engine build, warmup {warm_s} s; {booted} booting at once), exit 0 on SIGINT "
        f"[{card_line}]")
    return warm_s


def profile_phase(eng, tmp, card_line):
    """One synthesize with QTTS_PROFILE set: its trace must hold the
    ``synthesize`` range and K1's and K2's kernels by name."""
    os.environ["QTTS_PROFILE"] = tmp
    try:
        reset_launches()
        r = eng.synthesize(ENTRY_TEXT, language="en", temperature=0.0, max_tokens=16)
        counts = check_launches("profiled synthesize",
                                (r.metrics.decoded_frames, r.metrics.decoded_frames))
    finally:
        del os.environ["QTTS_PROFILE"]
    dirs = [x for x in os.listdir(tmp) if x.startswith("synthesize-")]
    if len(dirs) != 1:
        raise RuntimeError(f"profile: expected one trace directory, found {dirs}")
    with open(os.path.join(tmp, dirs[0], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    found = {key: sum(bool(re.search(pat, x)) for x in names)
             for key, pat in (("synthesize", r"^synthesize$"), ("K1", r"\bstep_kernel\b"),
                              ("K2", r"\bchain_kernel\b"))}
    if not all(found.values()):
        raise RuntimeError(f"profile: the trace lacks a range or a kernel: {found}")
    log(f"profile: {dirs[0]}/trace.json holds {len(events)} events: the synthesize range "
        f"{found['synthesize']}, K1 (step_kernel) {found['K1']}, K2 (chain_kernel) "
        f"{found['K2']} launches [{card_line}]")
    return counts


def entry_checkpoint(card_line):
    """Phase 10's checkpoint, beside the build (no kernel): the 0.6B preset's
    random weights from the seed with a speaker encoder, saved from the card
    into a temporary directory with the byte-level tokenizer, then loaded
    back and held equal bit for bit.  Returns (the directory object, the
    checkpoint's path, the params, the save and load figures)."""
    cfg = QWEN3_TTS_06B
    params = init_params(cfg, seed=SEED, device=DEV)
    tmp = tempfile.TemporaryDirectory()
    d = os.path.join(tmp.name, "qwen3-tts-0.6b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(d, cfg, params)
    save_s = time.perf_counter() - t0
    gb = os.path.getsize(os.path.join(d, "params.npz")) / 1e9
    byte_level_tokenizer(d)
    t0 = time.perf_counter()
    lcfg, lparams = load_checkpoint(d)
    load_s = time.perf_counter() - t0
    if lcfg != cfg or not same_checkpoint(lparams, params):
        raise RuntimeError("checkpoint: what was loaded differs from what was saved")
    del lparams
    log(f"checkpoint (beside the build): 0.6B preset, {param_count(params):,} random bf16 weights "
        f"(seed {SEED}) with a speaker encoder, {gb:.3f} GB of npz; save {save_s:.2f} s "
        f"({gb / save_s:.2f} GB/s, from the card), load {load_s:.2f} s "
        f"({gb / load_s:.2f} GB/s, to the host); equal bit for bit [{card_line}]")
    return tmp, d, params, dict(save_s=save_s, load_s=load_s, gb=gb)


def entry_phase(tok, card_line, checkpoint):
    """Phase 10: the entry points from ``checkpoint`` (:func:`entry_checkpoint`)
    at the 0.6B preset's full width.  Returns (launch counts, numbers)."""
    cfg = QWEN3_TTS_06B
    tmp_dir, d, params, numbers = checkpoint
    with tmp_dir as tmp:
        # the server at int8, bf16 (also with --kv-quant) and int4 units,
        # booting at once beside the CLI runs and the speaker embedding
        # below (their times then share the host and the card with the
        # boots)
        servers = start_servers(d, (("int8", ()), (None, ()), (None, ("--kv-quant",)),
                                    ("int4", ())))
        try:
            counts = _entry_checks(cfg, params, d, tmp, tok, numbers, card_line)
        except BaseException:
            finish_servers(servers, None, kill=True)
            raise
        (numbers["warmup_s"], numbers["warmup_bf16_s"], numbers["warmup_kvq_s"],
         _) = finish_servers(servers, card_line)
        del params
        eng = numbers.pop("eng")
        counts = [sum(c) for c in zip(counts, profile_phase(eng, tmp, card_line))]
    del eng
    torch.cuda.empty_cache()
    return counts, numbers


def _entry_checks(cfg, params, d, tmp, tok, numbers, card_line):
    """entry_phase's checks on the saved checkpoint ``d`` (the engine from
    the directory, the CLI, the speaker embedding); the engine goes into
    ``numbers["eng"]``.  Returns the CLI's launch counts."""
    t0 = time.perf_counter()
    eng = TTSEngine(d, quantize="int8")
    if not eng.is_ready():
        raise RuntimeError(f"engine from the directory: {eng.get_error()}")
    log(f"engine from the directory: built in {time.perf_counter() - t0:.2f} s (load, int8, "
        f"packs) [{card_line}]")
    mem = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    kw = dict(language="en", temperature=0.0, max_tokens=CLI_FRAMES)
    a, b = eng.synthesize(ENTRY_TEXT, **kw), mem.synthesize(ENTRY_TEXT, **kw)
    if not np.array_equal(a.codes, b.codes):
        raise RuntimeError("the engine from the directory decodes other greedy codes")
    log(f"engine from the directory: greedy codes equal to the engine on the same params "
        f"({len(a.codes)} frames)")
    del mem
    torch.cuda.empty_cache()

    (counts, numbers["cli_ms_frame"], ref, numbers["bf16_counts"],
     numbers["cli_bf16_ms_frame"], numbers["kvq_counts"],
     numbers["spec_counts"]) = cli_phase(d, tmp, card_line)

    e_card = eng.extract_speaker_embedding(ref)
    t0 = time.perf_counter()
    for _ in range(5):
        eng.extract_speaker_embedding(ref)
    numbers["spk_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    e_cpu = TTSEngine(d, device="cpu").extract_speaker_embedding(ref)
    rel = float(np.abs(e_card - e_cpu).max() / np.abs(e_cpu).max())
    log(f"speaker embedding of a 3 s WAV: {numbers['spk_ms']:.2f} ms per call on the card "
        f"(read, resample, log-mel, encoder), max|card - cpu| / max|cpu| = {rel:.2e} "
        f"(limit {SPK_REL}) [{card_line}]")
    if e_card.shape != (cfg.speaker_encoder.output_dim,) or not rel <= SPK_REL:
        raise RuntimeError("speaker embedding: the card disagrees with the CPU")
    numbers["eng"] = eng
    return counts


def voice_config():
    """The 1.7B preset with the talker's prefill attention on K8."""
    t = QWEN3_TTS_17B.talker
    return dataclasses.replace(QWEN3_TTS_17B, talker=dataclasses.replace(
        t, transformer=dataclasses.replace(t.transformer, attn_impl="pallas")))


def voice_phase(tok, gen, card_line):
    """The 1.7B voice slice at B=1 (phase 11).  Returns (launch counts, K1
    checks, K3 checks, K8 checks, bounds)."""
    cfg = voice_config()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    H = cfg.talker.hidden_size
    params["speaker_table"] = (torch.randn((len(PRESET_SPEAKERS), H), generator=gen,
                                           device=DEV) * 0.02).to(torch.bfloat16)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    del params
    torch.cuda.synchronize()
    log(f"engine: 1.7B preset (talker attn_impl=pallas), random weights (seed {SEED}) made on "
        f"the card, int8, bf16 KV cache, speaker table [{len(PRESET_SPEAKERS)}, {H}], built in "
        f"{time.perf_counter() - t0:.1f} s; KV ladder {eng.kv_ladder} [{CARD}]")

    talker_t, cp = cfg.talker.transformer, cfg.code_predictor
    fw_t = eng.params["talker"]["fused_step"]
    k1 = [check_k1_deep("talker-1.7B", talker_t, fw_t, 256, 60, gen, 20)]
    check_k1_equal("1.7B talker", talker_t, fw_t, ((256, 0), (256, 63), (256, 255)), gen)
    gen45 = torch.Generator(device=DEV)  # as in main: the other checks keep their inputs
    gen45.manual_seed(SEED + 17)
    check_k4_equal("1.7B talker", talker_t, fw_t, ((4, 256),), gen45)
    check_k6_equal("1.7B talker", talker_t, fw_t,
                   ((1, 4, 256, [200]), (4, 8, 512, [60, 5, 504, 200])), gen45)
    k1_ms, k1_by = step_bound(talker_t, fw_t, 1, [60], 1, torch.bfloat16)
    log(f"K1 talker-1.7B bound {k1_ms:.4f} ms ({k1_by}): {nbytes(fw_t) / 1e9:.3f} GB of packed "
        f"weights per step [{CARD}]")
    ts = dataclasses.replace(talker_t, num_layers=K1_SHALLOW_LAYERS)
    fws = packed_trunk(ts, gen)
    for cache_dtype in (torch.float32, torch.bfloat16):
        for T, pos in K1_17B_SHALLOW_CASES:
            k1.append(check_k1_shallow(f"talker-1.7B-{K1_SHALLOW_LAYERS}-layer", ts, fws, T, pos,
                                       cache_dtype, gen, 0))
    del fws

    cpp = eng.params["code_predictor"]
    if chain_kernel(cp, cpp, 1) is not K3.fused_mtp_chain_streamed:
        raise RuntimeError("the 1.7B B=1 chain does not route to K3")
    chain = (cp, cpp["fused_step"], cpp["fused_heads"], eng.params["embeddings"]["pred_embed"],
             cpp["transformer"]["final_norm"])
    # K5's mismatch rule: at H=2048 and I=6144 a GEMV input on a bf16 rounding
    # edge moves the trunk's x by ~1e-3 relative against the plain version,
    # and a near-tie sub-code flips (a 7.6e-4 relative score margin at step
    # 10 of one seeded chain on an H100); K3 vs K2 below is exact
    k3 = [check_chain("K3", K3.fused_mtp_chain_streamed, K3.fused_mtp_chain_streamed_reference,
                      knobs, *chain, gen, iters, flip_rule=True)
          for knobs, iters in (((0.8, 50, 0.95), 10), ((0.0,), 0), ((1.0, 0, 1.0), 0))]
    check_k2_equal("1.7B MTP trunk", *chain, gen, inputs=4, cache_dtypes=(torch.bfloat16,))
    check_k5_equal("1.7B MTP trunk", *chain, gen45, batches=(4,), inputs=2,
                   cache_dtypes=(torch.bfloat16,))
    k3_ms, k2_f32_ms = check_k3_equals_k2(*chain, gen, 10)
    k3[0] = (k3[0][0], k3_ms, k3[0][2])
    one_slot_ring(lambda: check_k3_equals_k2(*chain, gen45, 0, inputs=2))
    bounds = {"K3": chain_bound(cp.transformer, cpp["fused_step"], cpp["fused_heads"], 1)}
    log(f"K3 bound {bounds['K3'][0]:.4f} ms ({bounds['K3'][1]}, each input read once); "
        f"the trunk ({K2.trunk_bytes(cpp['fused_step']) / 1e6:.0f} MB) is past the 50 MB L2, so "
        f"each of the {cp.num_steps + 1} passes streams it: "
        f"{(cp.num_steps + 1) * K2.trunk_bytes(cpp['fused_step']) / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"[{CARD}]")

    _, i_bucket = instruct_segments(eng, VOICE_INSTRUCT, 1)
    P = prompt_length(LANG_ENGLISH, False, i_bucket)
    nq, nk = talker_t.num_heads, talker_t.num_kv_heads
    k8 = [check_k8("1.7B prefill", 1, P, eng.kv_ladder[0], nq, nk, "prefill", gen, iters=50)]
    k8 += [check_k8("random GQA", *shape, "random", gen) for shape in K8_RANDOM_SHAPES]
    k8 += [check_k8("key range", *case, gen) for case in K8_SCHEDULE_CASES]
    bounds["K8"] = k8[0][4]

    layers = talker_t.num_layers
    reset_launches()
    voiced = eng.synthesize(VOICE_TEXT, language="en", temperature=0.8, top_k=50, top_p=0.95,
                            max_tokens=48, seed=SEED, instruct=VOICE_INSTRUCT)
    preset = eng.synthesize_speaker("hello world, a preset speaker", "serena", language="en",
                                    temperature=0.0, max_tokens=48)
    decoded = 0
    for label, r in (("synthesize(instruct)", voiced), ("synthesize_speaker(serena)", preset)):
        m = r.metrics
        decoded += m.decoded_frames
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"bad 1.7B {label} output")
        log(f"1.7B {label}: {m.frames} frames ({m.decoded_frames} decoded), "
            f"{m.stage_seconds['decode'] * 1e3 / max(m.decoded_frames, 1):.3f} ms/frame decode, "
            f"prefill {m.stage_seconds['prefill'] * 1e3:.1f} ms, RTF {m.rtf:.2f}x, TTFA "
            f"{m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
    counts = [check_launches("1.7B synthesize(instruct) + synthesize_speaker (one K1 and one K3 "
                             f"per decoded frame, {layers} K8 per prefill)",
                             (decoded, 0, 0, 0, 0, decoded, 2 * layers))]
    reset_launches()
    ms = check_fixed_run(eng, FIXED_FRAMES, [VOICE_TEXT], card_line, instruct=VOICE_INSTRUCT)
    counts.append(check_launches("1.7B fixed run", (FIXED_FRAMES, 0, 0, 0, 0, FIXED_FRAMES,
                                                    layers)))
    figure("1.7B B=1 ms/frame", ms)
    log(f"1.7B fixed run with the instruction: {ms:.3f} ms/frame, RTF {1e3 / 12 / ms:.2f}x "
        f"(decode only; real time is 83.3 ms/frame) [{card_line}]")
    off = stream_off_run(eng, card_line)  # its own count: the per-step chain's K1 row
    del eng
    torch.cuda.empty_cache()
    return [sum(c) for c in zip(*counts)], k1, k3, k8, bounds, off


def stream_off_run(eng, card_line):
    """The 1.7B preset with ``QTTS_MTP_STREAM=0``: the trunk is past K2's
    residency gate and the streamed chain is off, so the B=1 chain is the
    per-step one (JAX's ``predict_subcodes_fused``): one K1 step per chain
    position past the prefix and one for the talker, no K3.  Returns the
    launch counts."""
    n = eng.cfg.code_predictor.num_steps
    layers = eng.cfg.talker.transformer.num_layers
    env = os.environ.get("QTTS_MTP_STREAM")
    os.environ["QTTS_MTP_STREAM"] = "0"
    try:
        if chain_route(eng.cfg.code_predictor, eng.params["code_predictor"], 1) != "per_step":
            raise RuntimeError("1.7B with QTTS_MTP_STREAM=0: the B=1 chain is not per-step")
        reset_launches()
        r = eng.synthesize(VOICE_TEXT, language="en", temperature=0.0, max_tokens=STREAM_OFF_FRAMES,
                           instruct=VOICE_INSTRUCT)
    finally:
        if env is None:
            del os.environ["QTTS_MTP_STREAM"]
        else:
            os.environ["QTTS_MTP_STREAM"] = env
    m = r.metrics
    if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
            r.audio).all() or r.codes.shape[1:] != (16,) or not m.decoded_frames:
        raise RuntimeError("bad 1.7B output with QTTS_MTP_STREAM=0")
    ms = m.stage_seconds["decode"] * 1e3 / m.decoded_frames
    log(f"1.7B with QTTS_MTP_STREAM=0: {m.frames} frames ({m.decoded_frames} decoded), "
        f"{ms:.3f} ms/frame decode on the per-step chain [{card_line}]")
    d = m.decoded_frames
    return check_launches(f"1.7B QTTS_MTP_STREAM=0 ({n} K1 per decoded frame: the talker's "
                          f"and {n - 1} chain positions; {layers} K8 per prefill)",
                          counts_of(K1=n * d, K8=layers))


def unit_pack(t, units, gen):
    """A random pack of ``t`` at ``units`` ("int8", "int4" or "bf16")."""
    return {"int8": packed_trunk, "int4": int4_trunk, "bf16": bf16_trunk}[units](t, gen)


def frame_packs(cfg, gen, talker="int8", trunk="int8"):
    """K7's first ten arguments at the preset's widths: random talker and
    trunk packs of the given units, lm_head and heads (bf16 rows with scales
    of one beside a bf16 talker, as the engine packs raw heads, else int8),
    bf16 codec and step tables, and final norms near 1."""
    tt, cp = cfg.talker.transformer, cfg.code_predictor
    mt = cp.transformer
    H, Vc, V, n = tt.hidden_size, cfg.talker.codec_vocab_size, cp.subcode_vocab_size, cp.num_steps

    def head(*shape):
        w = (torch.randn(shape, generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)
        return K2.pack_heads(w if talker == "bf16" else quantize_weight(w))

    def norm():
        return (1 + 0.1 * torch.randn((H,), generator=gen, device=DEV)).to(torch.bfloat16)

    def table(*shape):
        return (torch.randn(shape, generator=gen, device=DEV) * 0.02).to(torch.bfloat16)

    return (tt, mt, unit_pack(tt, talker, gen), norm(), head(H, Vc), table(Vc, H),
            unit_pack(mt, trunk, gen), norm(), head(n, H, V), table(n, V, H))


def k7_caches(tt, T, pos, cache_dtype, gen):
    """The talker caches [k, v] (and, int8, their scales) of one frame."""
    if cache_dtype == torch.int8:
        return q8_cache(tt, 1, T, [pos], gen)
    L, nk, d = tt.num_layers, tt.num_kv_heads, tt.head_dim
    kc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    return [kc, vc]


def k7_inputs(packs, pos, i, gen):
    """Seeded inputs of one frame (input i): last logits (CODEC_EOS on top
    when i % 4 < 2), the real control-token mask, bf16 hidden and drip as
    the engine's state holds them, the noise, and forbid_eos on even i."""
    H, Vc = packs[0].hidden_size, packs[4].q.shape[0]
    n, V, _ = packs[8].q.shape
    ll = torch.randn((1, Vc), generator=gen, device=DEV) * 2.0
    if i % 4 < 2:
        ll[0, CODEC_EOS] = 30.0
    return dict(
        last_logits=ll, last_hidden=(torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(
            torch.bfloat16),
        suppress=make_codec_suppress_mask(Vc, DEV),
        drip=(torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16),
        pos=pos, g0=gumbel_noise((1, Vc), gen, DEV), gumbel=gumbel_noise((n, 1, V), gen, DEV),
        forbid_eos=i % 2 == 0)


def k7_call(fn, packs, inp, knobs, *caches):
    """K7 (or its plain version) on one input and the talker caches k, v (and
    an int8 cache's k and v scales); the noise only when sampled.  Returns
    code0, the sub-codes, logits and hidden."""
    temp, top_k, top_p = knobs
    sampled = temp > 0
    kc, vc, *scales = caches
    return fn(*packs, inp["last_logits"], inp["last_hidden"], inp["suppress"], inp["drip"],
              inp["pos"], kc, vc, inp["g0"] if sampled else None,
              inp["gumbel"] if sampled else None, temp, top_k, top_p, inp["forbid_eos"],
              mtp_cache_dtype=K7.chain_cache_dtype(kc.dtype),
              **dict(zip(("k_scale", "v_scale"), scales)))[:4]


def k7_multi(*a, **kw):
    """The launch-per-op frame kernel (``qtts_frame_step_multi``) with
    :func:`fused_frame_step`'s arguments: the reference the persistent K7 is
    held to bit for bit."""
    return K7._launch_frame(k7_multi, "qtts_frame_step_multi", *a, **kw)


k7_multi.launches = 0  # not a kernel of the path: compare-only launches


def k7_composition(packs, inp, knobs, code0, caches):
    """The frame from checked kernels on K7's code0: K2 on its codec row (at
    the chain's cache dtype), the float32 next input c0e + sub_sum + drip,
    K1 (``caches`` updated in place), then K1's GEMV body on the final norm
    (qtts_norm_head).  Returns c0e, sub-codes, sub_sum, x, hidden and
    logits."""
    tt, mt, tfw, tfnorm, lm, codec, mfw, mfnorm, heads, tables = packs
    temp, top_k, top_p = knobs
    c0e = codec[code0.long()].float()
    subs, ssum = K2.fused_mtp_chain(mt, mfw, mfnorm, heads, tables, inp["last_hidden"], c0e,
                                    inp["gumbel"] if temp > 0 else None, temp, top_k, top_p,
                                    cache_dtype=K7.chain_cache_dtype(caches[0].dtype))
    x = c0e + ssum + inp["drip"].float()
    x = K1.fused_decode_step(tt, tfw, x, inp["pos"], *caches)[0]
    H, Vc = tt.hidden_size, lm.q.shape[0]
    hidden = torch.empty((1, H), dtype=torch.float32, device=DEV)
    logits = torch.empty((1, Vc), dtype=torch.float32, device=DEV)
    fn = tfnorm.float().contiguous()
    err = _build.load_kernels().qtts_norm_head(
        x.data_ptr(), fn.data_ptr(), tt.rms_norm_eps, lm.q.data_ptr(), lm.scale.data_ptr(),
        hidden.data_ptr(), logits.data_ptr(), Vc, H, int(lm.q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "qtts_norm_head")
    return c0e, subs, ssum, x, hidden, logits


def check_k7_composition(packs, T, pos, cache_dtype, gen, inputs=K7_INPUTS):
    """K7 against the launch-per-op frame kernel it replaced (``k7_multi``)
    and the composition of checked kernels on ``inputs`` seeded inputs per
    knob set: code0 the plain sampler's pick on the same logits and noise (a
    near tie passes by K5's flip rule, counted); code0, the sub-codes, c0e,
    sub_sum, x, the talker caches, hidden and logits equal the launch-per-op
    frame's bit for bit, and all but code0 the composition's on K7's code0.
    An int8 cache (``cache_dtype`` int8: its scales too) and units other
    than int8 have no launch-per-op frame: the composition alone.  Returns
    the number of frames compared."""
    tt = packs[0]
    base = k7_caches(tt, T, pos, cache_dtype, gen)
    units = [K1.UNIT_NAMES[packs[i].wqkv.dtype] for i in (2, 6)]
    multi = cache_dtype != torch.int8 and units == ["int8", "int8"]
    equal = flips = eos = frames = 0
    names = ("c0e", "subcodes", "sub_sum", "x", "caches", "hidden", "logits")
    for knobs in K7_KNOBS:
        for i in range(inputs):
            inp = k7_inputs(packs, pos, i, gen)
            ck = clone_all(base)
            code0, subs, logits, hidden = k7_call(K7.fused_frame_step, packs, inp, knobs, *ck)
            work = {k: v.clone() for k, v in K7.frame_work(*packs, T, cache_dtype).items()}
            logits0 = K7._eos_gate(inp["last_logits"], inp["suppress"], inp["forbid_eos"])
            g0 = inp["g0"] if knobs[0] > 0 else None
            pick = int(K2.gumbel_topk_topp_sample(logits0, g0, *knobs)[0])
            c0 = int(code0[0])
            if c0 != pick:
                if flip_eps(logits0, g0, knobs, c0, gen) is None:
                    raise RuntimeError(f"K7 T={T} pos={pos} knobs {knobs} input {i}: code0 {c0} "
                                       f"is not the plain sampler's pick {pick}")
                flips += 1
            eos += c0 == CODEC_EOS
            same_m = [True]
            if multi:
                cm = clone_all(base)
                m_code0, m_subs, m_logits, m_hidden = k7_call(k7_multi, packs, inp, knobs, *cm)
                m_work = K7.frame_work(*packs, T, cache_dtype, entry="qtts_frame_step_multi")
                same_m = [torch.equal(m_work["c0e"], work["c0e"]), torch.equal(m_subs, subs),
                          torch.equal(m_work["sub_sum"], work["sub_sum"]),
                          torch.equal(m_work["x"], work["x"]), equal_all(cm, ck),
                          torch.equal(m_hidden, hidden), torch.equal(m_logits, logits),
                          torch.equal(m_code0, code0)]
            cc = clone_all(base)
            c0e, s2, sum2, x, h, lg = k7_composition(packs, inp, knobs, code0, cc)
            same = [torch.equal(c0e, work["c0e"][None]), torch.equal(s2, subs),
                    torch.equal(sum2, work["sub_sum"][None]), torch.equal(x, work["x"][None]),
                    equal_all(cc, ck), torch.equal(h, hidden), torch.equal(lg, logits)]
            equal += all(same) and all(same_m)
            frames += 1
            if not (all(same) and all(same_m)):
                log(f"K7 T={T} pos={pos} knobs {knobs} input {i}: differs from the composition in "
                    f"{[nm for nm, ok in zip(names, same) if not ok]}, from the launch-per-op "
                    f"frame in {[nm for nm, ok in zip(names + ('code0',), same_m) if not ok]}")
    ok = equal == frames
    log(f"K7 vs {'the launch-per-op frame and ' if multi else ''}K2 -> float32 x -> K1 -> "
        f"norm+lm_head: talker {units[0]}, trunk {units[1]}, {packs[4].q.dtype} heads, T={T} "
        f"pos={pos} "
        f"cache={str(cache_dtype)[6:]} knobs {K7_KNOBS}: {equal}/{frames} frames equal bit for bit "
        f"(code0, c0e, sub-codes, sub_sum, x, caches, hidden, logits); code0 = plain pick on "
        f"{frames - flips}/{frames} (near-tie flips {flips}), EOS drawn {eos} -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K7 T={T} pos={pos} differs from the launch-per-op frame or the "
                           "composition of K2 and K1")
    return frames


def check_k7_plain(packs, T, pos, knobs, gen, iters=0, cache_dtype=torch.bfloat16):
    """K7 against its plain version on one seeded input: code0 and the
    sub-codes equal, or the first mismatch within K5's flip rule (then
    nothing after it is compared); else hidden and logits within K1's deep
    relative limit, the written slot (dequantized, on an int8 cache) within
    its absolute limit and every other slot (and scale) untouched.  With
    ``iters``, both timed beside the composition.  Returns (hidden
    max_abs_err, ms, plain ms, composition ms)."""
    tt = packs[0]
    base = k7_caches(tt, T, pos, cache_dtype, gen)
    inp = k7_inputs(packs, pos, 1, gen)
    ck, cp = clone_all(base), clone_all(base)
    got = k7_call(K7.fused_frame_step, packs, inp, knobs, *ck)
    seen = []
    real = K2.gumbel_topk_topp_sample

    def record(logits, g, *a):
        seen.append((logits.clone(), None if g is None else g.clone()))
        return real(logits, g, *a)

    K2.gumbel_topk_topp_sample = K7.gumbel_topk_topp_sample = record
    try:
        # the checked call, timed (its sampler inputs recorded)
        want, plain_call_ms = timed_call(
            lambda: k7_call(K7.fused_frame_step_reference, packs, inp, knobs, *cp))
    finally:
        K2.gumbel_topk_topp_sample = K7.gumbel_topk_topp_sample = real
    codes_k = got[0].tolist() + got[1][0].tolist()
    codes_p = [int(c) for c in want[0].tolist()] + want[1][0].tolist()
    diff = [j for j in range(len(codes_k)) if codes_k[j] != codes_p[j]]
    err = 0.0
    if diff:
        j = diff[0]
        logits, g = seen[j]
        eps = flip_eps(logits, g, knobs, codes_k[j], gen)
        ok = eps is not None
        detail = (f"first code mismatch at {'code0' if j == 0 else f'sub-code {j - 1}'}: kernel "
                  f"{codes_k[j]} plain {codes_p[j]}, flip eps {eps} (tol {K5_FLIP_EPS[-1]})")
    else:
        err = float((got[3] - want[3]).abs().max())
        rel = err / float(want[3].abs().max())
        lrel = float((got[2] - want[2]).abs().max()) / float(want[2].abs().max())
        rows, slots = torch.tensor([0], device=DEV), torch.tensor([pos], device=DEV)
        slot_err = float((cache_slots(ck, rows, slots) - cache_slots(cp, rows, slots)).abs().max())
        written = torch.zeros((1, T), dtype=torch.bool, device=DEV)
        written[0, pos] = True
        untouched = untouched_slots(ck, base, written)
        ok = (rel < K1_DEEP_X_REL and lrel < K1_DEEP_X_REL and slot_err < K1_DEEP_SLOT_ABS
              and untouched and bool(torch.isfinite(got[2]).all()))
        detail = (f"codes equal; hidden max_abs_err={err:.3e} rel={rel:.3e} logits rel={lrel:.3e} "
                  f"(tol {K1_DEEP_X_REL}) slot max_abs_err={slot_err:.3e} (tol "
                  f"{K1_DEEP_SLOT_ABS}) untouched_slots_equal={untouched}")
    ms = plain_ms = comp_ms = float("nan")
    if iters:
        ms = time_ms(lambda: k7_call(K7.fused_frame_step, packs, inp, knobs, *ck), iters)
        code0 = got[0]
        comp_ms = time_ms(lambda: k7_composition(packs, inp, knobs, code0, cp), iters)
        plain_ms = plain_call_ms
    log(f"K7 vs plain: T={T} pos={pos} cache={str(cache_dtype)[6:]} knobs {knobs}: {detail}; "
        f"kernel {ms:.4f} ms/frame, "
        f"K2 + K1 + norm_head {comp_ms:.4f} ms, plain {plain_ms:.4f} ms -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K7 T={T} pos={pos} knobs {knobs} disagrees with its plain version")
    return err, ms, plain_ms, comp_ms


def frame_bound(packs, pos, cache_dtype, trunk_reads=1):
    """Bound of one K7 frame: the talker pack, the trunk pack ``trunk_reads``
    times, the heads and the lm_head, the talker's slots 0..pos and the new
    slot, the codec and table rows, the logits, mask and noise in and the
    logits out; the GEMV products of one talker step, 16 trunk passes, 15
    heads and the lm_head, and the attention of both."""
    tt, mt, tfw, _, lm, _, mfw, _, heads, _ = packs
    n, V, H = heads.q.shape
    Vc = lm.q.shape[0]
    L, nk, nq, d = tt.num_layers, tt.num_kv_heads, tt.num_heads, tt.head_dim
    slot = slot_bytes(tt, cache_dtype)
    moved = (nbytes(tfw) + trunk_reads * nbytes(mfw) + nbytes(heads) + nbytes(lm)
             + slot * (pos + 2) + (n + 1) * H * 2 + 4 * Vc * 4 + n * V * 4 + 4 * H * 4)
    macs = [sum(w.numel() for w in (fw.wqkv, fw.wo, fw.wgu, fw.wd)) for fw in (tfw, mfw)]
    chain_attn = mt.num_layers * 4 * mt.num_heads * mt.head_dim * sum(range(1, n + 2))
    ops = 2 * (macs[0] + (n + 1) * macs[1] + n * V * H + Vc * H) + 4 * L * nq * d * (pos + 1)
    return bound(moved, ops + chain_attn)


def frame_checks(cfg, gen):
    """K7 at the preset's widths: against the launch-per-op frame kernel and
    the composition on every case with bf16 and float32 caches, and with a
    one-slot ring; timed in turns with the launch-per-op frame and traced;
    against its plain version per case and knob set, timed at the first
    bucket's last slot.  Returns (report checks, bound, frames compared)."""
    packs = frame_packs(cfg, gen)
    tt, mt, n = packs[0], packs[1], cfg.code_predictor.num_steps
    p = K7.frame_plan(*packs, 256, torch.bfloat16).plan
    log(f"K7 plan: grid {p.grid} blocks of 256 threads on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, {p.n_slots} ring slots "
        f"of {p.slot_bytes} B, stage rows {p.stage_rows} (MTP trunk and heads, then talker and "
        f"lm_head), {p.smem_bytes} B of dynamic shared memory; one cooperative launch per frame "
        f"[{CARD}]")
    frames = check_k7_composition(packs, 256, 64, torch.float32, gen, inputs=4)
    for T, pos in K7_CASES:
        frames += check_k7_composition(packs, T, pos, torch.bfloat16, gen)
    # the float32 cache at the other cases, one ring slot, the timing and the
    # trace draw from a generator of their own: the checks after keep their
    # inputs
    gen7 = torch.Generator(device=DEV)
    gen7.manual_seed(SEED + 7)
    for T, pos in K7_CASES[1:]:
        frames += check_k7_composition(packs, T, pos, torch.float32, gen7, inputs=2)
    inp = k7_inputs(packs, 255, 1, gen7)
    caches = k7_caches(tt, 256, 255, torch.bfloat16, gen7)
    knobs = K7_KNOBS[1]
    in_turns(f"K7 0.6B frame T=256 pos 255 sampled {knobs}",
             lambda: k7_call(k7_multi, packs, inp, knobs, *caches),
             lambda: k7_call(K7.fused_frame_step, packs, inp, knobs, *caches), 10)
    trace_phases(f"K7 0.6B frame T=256 pos 255 sampled {knobs}",
                 K7.frame_plan(*packs, 256, torch.bfloat16),
                 frame_phase_names(tt.num_layers, mt.num_layers, n),
                 lambda: k7_call(K7.fused_frame_step, packs, inp, knobs, *caches))
    del caches
    frames += one_slot_ring(lambda: check_k7_composition(packs, 256, 255, torch.bfloat16, gen7,
                                                         inputs=2))
    timed, checks = None, []
    for T, pos in K7_CASES:
        for knobs in K7_KNOBS:
            if (T, pos) == (256, 255) and knobs == K7_KNOBS[1]:
                timed = check_k7_plain(packs, T, pos, knobs, gen, 20)
            else:
                checks.append(check_k7_plain(packs, T, pos, knobs, gen))
    checks.insert(0, timed)  # the report reads ms and plain ms from the first
    b_ms, b_by = frame_bound(packs, 255, torch.bfloat16)
    b16_ms, _ = frame_bound(packs, 255, torch.bfloat16, trunk_reads=cfg.code_predictor.num_steps + 1)
    log(f"K7 bound at pos 255: {b_ms:.4f} ms ({b_by}) with each input read once "
        f"({nbytes(packs[2]) / 1e6:.1f} MB talker, {nbytes(packs[6]) / 1e6:.1f} MB trunk); "
        f"{b16_ms:.4f} ms with the trunk streamed once per pass "
        f"({cfg.code_predictor.num_steps + 1} passes, past the 50 MB L2) [{CARD}]")
    del packs
    torch.cuda.empty_cache()
    return checks, (b_ms, b_by), frames


def check_p1_ring(gen, calls=10):
    """P1's ring kernel against the group kernel it replaced (``p1_multi``),
    every arm, bit for bit: the 2-unit chain and the whole chain (U units x
    S steps) from the probe's input and from a seeded one; then each arm
    timed in turns with it (group, ring, ring, group).  Returns {arm: (ring
    ms, group ms)} per call of the whole chain."""
    times = {}
    for arm in P1.ARMS:
        w, s = P1.make_weights(arm, device=DEV)
        x0 = torch.full((P1.rows(arm), P1.H), 0.1, device=DEV)
        xr = torch.randn((P1.rows(arm), P1.H), generator=gen, device=DEV)
        runs = [(w[:P1.SHORT_UNITS], s[:P1.SHORT_UNITS], x, 1) for x in (x0, xr)]
        runs += [(w, s, x, P1.S) for x in (x0, xr)]
        equal = sum(bool(torch.equal(P1.chain(arm, *r), p1_multi(arm, *r))) for r in runs)
        log(f"P1 {arm} ring kernel vs the group kernel: {equal}/{len(runs)} chains equal bit for "
            f"bit ({P1.SHORT_UNITS}-unit and {P1.S} x {w.shape[0]}-unit chains, the probe's and "
            f"a seeded input) -> {'ok' if equal == len(runs) else 'FAIL'} [{CARD}]")
        if equal != len(runs):
            raise RuntimeError(f"P1 {arm}: the ring kernel differs from the group kernel")
        times[arm] = in_turns(f"P1 {arm} chain of {P1.S * w.shape[0]} units",
                              lambda: p1_multi(arm, w, s, x0), lambda: P1.chain(arm, w, s, x0),
                              calls, names=("group kernel", "ring"))
        del w, s
    return times


# a late stage (the checks' one-slot pass): each block's thread 0 issues a
# stage past the first only this long after its other warps reach their
# wait, so a stage read before its wait reads the slot's previous unit
P2_STALL_NS = 20_000


def check_p2_ring(gen, calls=10):
    """P2's ring kernel against the group kernel it replaced (``p2_multi``),
    both arms, bit for bit: a 2-unit chain (one pass) and the whole chain (U
    units x P passes) from the probe's input and from a seeded one; a 2-unit
    and a whole chain again with a one-slot ring whose stages are issued
    P2_STALL_NS late; then each arm timed in turns with the group
    kernel (group, ring, ring, group).  Returns {arm: (ring ms, group ms)}
    per call of the whole chain."""
    times = {}
    w, s, x0 = P2.make_inputs(DEV)
    xr = torch.randn((1, P2.H), generator=gen, device=DEV)
    runs = [(w[:2], s[:2], x, 1) for x in (x0, xr)] + [(w, s, x, P2.P) for x in (x0, xr)]
    for arm in P2.ARMS:
        equal = sum(bool(torch.equal(P2.chain(arm, *r), p2_multi(arm, *r))) for r in runs)
        slot = one_slot_ring(lambda: sum(bool(torch.equal(P2.chain(arm, *r), p2_multi(arm, *r)))
                                         for r in runs[1:3]), probe_stall_ns=P2_STALL_NS)
        log(f"P2 {arm} ring kernel vs the group kernel: {equal}/{len(runs)} chains equal bit for "
            f"bit (2-unit and {P2.P} x {w.shape[0]}-unit chains, the probe's and a seeded input), "
            f"{slot}/2 with a one-slot ring and stages issued {P2_STALL_NS} ns late -> "
            f"{'ok' if equal == len(runs) and slot == 2 else 'FAIL'} [{CARD}]")
        if equal != len(runs) or slot != 2:
            raise RuntimeError(f"P2 {arm}: the ring kernel differs from the group kernel")
        times[arm] = in_turns(f"P2 {arm} chain of {P2.P * w.shape[0]} units",
                              lambda: p2_multi(arm, w, s, x0), lambda: P2.chain(arm, w, s, x0),
                              calls, names=("group kernel", "ring"))
    return times


def probe_phase():
    """Probes P1 and P2 through their entry points: every arm against its
    plain version and timed beside one PyTorch call of the unit product,
    both only on the ring kernel.  Returns (launch counts, P1 results, P2
    results)."""
    reset_launches()
    p1 = P1.run()
    if ENTRY_CALLS != {"qtts_unit_probe_ring": P1.chain.launches}:
        raise RuntimeError(f"P1's entry point ran {ENTRY_CALLS}, not only the ring kernel")
    p2 = P2.run()
    if ENTRY_CALLS != {"qtts_unit_probe_ring": P1.chain.launches + P2.chain.launches}:
        raise RuntimeError(f"P2's entry point ran {ENTRY_CALLS}, not only the ring kernel")
    counts = launches()
    for r in p1 + p2:
        if not (r["ok"] and r["finite"]):
            raise RuntimeError(f"probe arm {r['arm']} disagrees with its plain version")
    log("launches on the probes' entry points: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, counts) if n))
    return counts, p1, p2


def profile_frames(eng, label, card_line, frames=8, B=1):
    """Device time over ``frames`` single-frame decodes of B streams at the
    256 bucket (after three warm ones), from ``torch.profiler``: device busy
    and idle share per (batched) frame, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    fns = eng._get_fns(LANG_ENGLISH, 256, 1, B)
    ids = eng._tokenize(FIXED_TEXT)
    gens = []
    for b in range(B):
        gens.append(torch.Generator(device=DEV))
        gens[-1].manual_seed(SEED + b)
    sp = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    state, bundle = fns.prefill(eng.params, torch.tensor([ids] * B, device=DEV),
                                torch.tensor([len(ids)] * B, device=DEV),
                                gens[0] if B == 1 else gens)

    def frame(st):
        return fns.decode(eng.params, st, bundle.trailing, bundle.trailing_len,
                          bundle.tts_pad_embed, sp)[0]

    for _ in range(3):
        state = frame(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            state = frame(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    log(f"frame profile, {label}: {frames} frames, wall {wall_ms / frames:.3f} ms/frame "
        f"(profiler on), device busy {busy_ms / frames:.3f} ms/frame, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kernels) / frames:.1f} device ops "
        f"per frame; top: " + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / frames:.3f}"
                                        f" ms x{e.count / frames:g}" for e in top)
        + f" [{card_line}]")
    return busy_ms / frames, 1 - busy_ms / wall_ms


def frame_fused_phase(eng, ff_eng, requests, card_line):
    """TTSEngine(frame_fused=True) at the 0.6B preset: ``requests`` through
    ``synthesize`` and one through ``synthesize_stream``, one K7 launch per
    decoded frame and no K1 or K2; fixed FIXED_FRAMES-frame runs in turns with the
    multi-dispatch engine (multi, K7, K7, multi); greedy agreement with it,
    printed as data; a profile of single frames on both.  Returns (launch
    counts, ms/frame by engine)."""
    reset_launches()
    decoded = 0
    for req in requests:
        r = ff_eng.synthesize(max_tokens=48, seed=SEED, **req)
        m = r.metrics
        decoded += m.decoded_frames
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,) or (
                m.frame_fused_frames != m.decoded_frames):
            raise RuntimeError(f"bad frame_fused synthesis output for {req}")
        log(f"frame_fused synthesize {req['language']} T={req['temperature']}: {m.frames} frames "
            f"({m.decoded_frames} decoded, {m.frame_fused_frames} by K7), "
            f"{m.stage_seconds['decode'] * 1e3 / max(m.decoded_frames, 1):.3f} ms/frame decode, "
            f"RTF {m.rtf:.2f}x, TTFA {m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
    items = list(ff_eng.synthesize_stream("hello world, streamed frame by frame", language="en",
                                          temperature=0.8, max_tokens=48, seed=SEED))
    res, m = items[-1], items[-1].metrics
    streamed = np.concatenate(items[:-1])[: res.audio.shape[0]]
    if not np.array_equal(streamed, res.audio) or m.frame_fused_frames != m.decoded_frames:
        raise RuntimeError("frame_fused synthesize_stream: chunks differ from the result")
    decoded += m.decoded_frames
    log(f"frame_fused synthesize_stream: {len(items) - 1} chunks, {m.frames} frames, TTFA "
        f"{m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
    k7_only = (0,) * KERNEL_IDS.index("K7")
    counts = [check_launches("frame_fused synthesize + synthesize_stream (one K7 per decoded "
                             "frame, no K1 or K2)", k7_only + (decoded,))]
    ms = {"multi-dispatch": [], "frame_fused": []}
    for label, e in (("multi-dispatch", eng), ("frame_fused", ff_eng), ("frame_fused", ff_eng),
                     ("multi-dispatch", eng)):
        reset_launches()
        ms[label].append(check_fixed_run(e, FIXED_FRAMES, [FIXED_TEXT], card_line))
        counts.append(check_launches(f"fixed run, {label}", (FIXED_FRAMES, FIXED_FRAMES)
                                     if e is eng else k7_only + (FIXED_FRAMES,)))
    means = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"fixed run B=1 in turns (multi, K7, K7, multi): multi-dispatch {ms['multi-dispatch']} "
        f"frame_fused {ms['frame_fused']} ms/frame; means {means['multi-dispatch']:.3f} vs "
        f"{means['frame_fused']:.3f} (RTF {1e3 / 12 / means['multi-dispatch']:.2f}x vs "
        f"{1e3 / 12 / means['frame_fused']:.2f}x) [{card_line}]")
    kw = dict(language="en", temperature=0.0, max_tokens=64)
    a = eng.synthesize("hello world, greedy through both paths", **kw).codes
    b = ff_eng.synthesize("hello world, greedy through both paths", **kw).codes
    same = next((i for i in range(min(len(a), len(b))) if not np.array_equal(a[i], b[i])),
                min(len(a), len(b)))
    log(f"greedy frame_fused vs multi-dispatch (data, not required): {len(b)} vs {len(a)} frames, "
        f"first {same} frames equal (K7's next input is float32, the multi-dispatch one bf16)")
    prof = {label: profile_frames(e, label, card_line)
            for label, e in (("multi-dispatch", eng), ("frame_fused", ff_eng))}
    return [sum(c) for c in zip(*counts)], means, prof


# ---------------------------------------------------------------------------
# bf16 weight units (quantize=None): K1, K3, K4 and K5 at bits=16
# ---------------------------------------------------------------------------

# The unquantized config's figures beside the int8 ones of the same run:
# (int8, bf16) by name, filled by the phases and printed by bf16_phase.
FIGURES = {}


def figure(name, value):
    """Record ``value``: the int8 figure first, then the bf16 one."""
    FIGURES[name] = FIGURES.get(name, ()) + (value,)


def batched_figures(ms):
    """ms per batched frame at B=8 and 32 and B=8's aggregate decode RTF."""
    figure("0.6B ms per batched frame B=8, B=32", (ms[8], ms[32]))
    figure("0.6B aggregate decode RTF B=8", 8 * 1e3 / 12 / ms[8])
# the chains' knob sets of the bf16 anchors: greedy and two sampled sets
UNIT_KNOBS = ((0.0, 50, 0.9), (0.8, 50, 0.95), (0.7, 1, 0.9))


def unit_pair(t, gen):
    """An int8 pack of ``t`` with its scales set to one, and its twin whose
    bf16 units hold the same int8 values (exact): K1 / K4 / K3 / K5 on the
    two must agree bit for bit, since every weight converts to the same
    float and the FMA order is the int8 path's."""
    i8 = packed_trunk(t, gen)
    i8 = i8._replace(**{k: torch.ones_like(getattr(i8, k)) for k in ("sqkv", "so", "sgu", "sd")})
    b16 = i8._replace(**{k: getattr(i8, k).to(torch.bfloat16) for k in ("wqkv", "wo", "wgu", "wd")})
    return i8, b16


def heads_pair(cp, gen):
    """The chain's int8 heads with scales of one, and their bf16 twin."""
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    h8 = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)))
    h8 = h8._replace(scale=torch.ones_like(h8.scale))
    return h8, h8._replace(q=h8.q.to(torch.bfloat16))


def bf16_trunk(t, gen):
    """A real bf16 pack of ``t`` (random weights, bits=16: scales of one)."""
    layers = fuse_params({"m": {"transformer": init_transformer_params(t, gen, DEV)}},
                         modules=("m",))["m"]["transformer"]["layers"]
    return K1.pack_fused_weights(t, layers, bits=16)


def bf16_heads(cp, gen):
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    return K2.pack_heads((torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(
        torch.bfloat16))


def check_unit_anchor_k1(name, t, i8, b16, cases, gen, cache_dtypes=(torch.bfloat16, torch.float32)):
    """K1 on the bf16 twin against K1 on the int8 pack (unit scales), one
    seeded input per (T, pos) of ``cases`` and cache dtype: x and both
    caches equal bit for bit.  Returns the number of steps compared."""
    equal = total = 0
    for T, pos in cases:
        for cache_dtype in cache_dtypes:
            x, kc, vc = k1_inputs(t, T, pos, cache_dtype, gen)
            k8, v8, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            x8, _, _ = K1.fused_decode_step(t, i8, x, pos, k8, v8)
            xb, _, _ = K1.fused_decode_step(t, b16, x, pos, kb, vb)
            same = bool(torch.equal(x8, xb)) and bool(torch.equal(k8, kb)) and bool(
                torch.equal(v8, vb))
            if not same:
                log(f"K1 bf16 anchor {name} T={T} pos={pos} cache={str(cache_dtype)[6:]}: x max "
                    f"diff {float((x8 - xb).abs().max()):.3e}")
            equal += same
            total += 1
    ok = equal == total
    log(f"K1 bf16 units vs int8 units (int8-valued bf16, unit scales), {name}: L={t.num_layers} "
        f"(T, pos) {list(cases)} x caches {[str(d)[6:] for d in cache_dtypes]}: {equal}/{total} "
        f"steps equal bit for bit (x, k and v caches) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K1 on bf16 units differs from K1 on int8 units ({name})")
    return total


def check_unit_anchor_k4(name, t, i8, b16, batches, T, gen):
    """K4 on the bf16 twin against K4 on the int8 pack at B rows of
    ``batches`` (k4_inputs' per-row positions), both cache dtypes: x and
    both caches equal bit for bit."""
    equal = total = 0
    for B in batches:
        for cache_dtype in (torch.bfloat16, torch.float32):
            x, kc, vc, pos = k4_inputs(t, B, T, cache_dtype, gen)
            pos_dev = torch.tensor(pos, device=DEV)
            k8, v8, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            x8, _, _ = K1.fused_decode_step_batched(t, i8, x, pos_dev, k8, v8)
            xb, _, _ = K1.fused_decode_step_batched(t, b16, x, pos_dev, kb, vb)
            same = bool(torch.equal(x8, xb)) and bool(torch.equal(k8, kb)) and bool(
                torch.equal(v8, vb))
            equal += same
            total += 1
            del kc, vc, k8, v8, kb, vb
    ok = equal == total
    log(f"K4 bf16 units vs int8 units, {name}: L={t.num_layers} B {list(batches)} T={T} x caches "
        f"bf16/f32: {equal}/{total} steps equal bit for bit (x, k and v caches) -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K4 on bf16 units differs from K4 on int8 units ({name})")
    return total


def check_unit_anchor_chains(label, cp, i8, h8, b16, h16, tables, fnorm, gen, batches=(8,),
                             knob_sets=UNIT_KNOBS):
    """K3 (B=1) and K5 (B rows of ``batches``, the knob sets cycled over the
    rows) on the bf16 twins against the same kernels on the int8 pack and
    heads (unit scales), float32 cache, the same inputs and noise: sub-codes
    and sub_sum equal bit for bit."""
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    t = cp.transformer
    equal = total = 0
    for knobs in knob_sets:
        sp = SamplingParams.create(*knobs)
        lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        noise = None if sp.greedy else gumbel_noise((n, 1, V), gen, DEV)
        rest = (tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p)
        s8, sum8 = K3.fused_mtp_chain_streamed(t, i8, fnorm, h8, *rest)
        sb, sumb = K3.fused_mtp_chain_streamed(t, b16, fnorm, h16, *rest)
        same = bool(torch.equal(s8, sb)) and bool(torch.equal(sum8, sumb))
        if not same:
            log(f"K3 {label} knobs {knobs}: int8 {s8[0].tolist()} bf16 {sb[0].tolist()}")
        equal += same
        total += 1
    for B in batches:
        knobs = [knob_sets[b % len(knob_sets)] for b in range(B)]
        temps, ks, ps = zip(*knobs)
        lh = (torch.randn((B, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((B, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        rest = (tables, lh, c0, gumbel_noise((n, B, V), gen, DEV), temps, ks, ps)
        s8, sum8 = K2.fused_mtp_chain_batched(t, i8, fnorm, h8, *rest, cache_dtype=torch.float32)
        sb, sumb = K2.fused_mtp_chain_batched(t, b16, fnorm, h16, *rest, cache_dtype=torch.float32)
        same = bool(torch.equal(s8, sb)) and bool(torch.equal(sum8, sumb))
        if not same:
            log(f"K5 {label} B={B}: the bf16 chain differs from the int8 one")
        equal += same
        total += 1
    ok = equal == total
    log(f"K3 and K5 bf16 units vs int8 units, {label}: K3 on knobs {list(knob_sets)}, K5 at B "
        f"{list(batches)}, float32 cache: {equal}/{total} chains equal bit for bit (sub-codes, "
        f"sub_sum) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"the chains on bf16 units differ from those on int8 units ({label})")
    return total


def bf16_anchors(cfg, gen):
    """The bit-for-bit anchors of the bf16 kernels at the 0.6B widths: bf16
    twins of int8 packs (K1 at the talker and the trunk, K4 at B=8 and 32,
    K3 and K5), then real bf16 packs: K4 rows against K1 and K5 rows against
    K3, bit for bit; each kernel against its plain version with the int8
    kernels' limits; one pass on a one-slot ring.  Returns the (error, ms,
    plain ms) checks of K1, K4, K3 and K5 and their bounds."""
    talker_t, cp = cfg.talker.transformer, cfg.code_predictor
    mtp_t = cp.transformer
    H, V, n = mtp_t.hidden_size, cp.subcode_vocab_size, cp.num_steps
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    i8, b16 = unit_pair(talker_t, gen)
    check_unit_anchor_k1("0.6B talker", talker_t, i8, b16,
                         ((256, 0), (256, 63), (256, 255), (2560, 64), (2560, 2559)), gen)
    check_unit_anchor_k4("0.6B talker", talker_t, i8, b16, (8, 32), 512, gen)
    del i8, b16
    mi8, mb16 = unit_pair(mtp_t, gen)
    h8, h16 = heads_pair(cp, gen)
    check_unit_anchor_k1("0.6B MTP trunk", mtp_t, mi8, mb16, ((17, 0), (17, 9), (17, 16)), gen)
    check_unit_anchor_k4("0.6B MTP trunk", mtp_t, mi8, mb16, (8, 32), 17, gen)
    check_unit_anchor_chains("0.6B MTP trunk", cp, mi8, h8, mb16, h16, tables, fnorm, gen,
                             batches=(8, 32))
    one_slot_ring(lambda: (
        check_unit_anchor_k1("0.6B MTP trunk, one ring slot", mtp_t, mi8, mb16, ((17, 16),), gen),
        check_unit_anchor_chains("0.6B MTP trunk, one ring slot", cp, mi8, h8, mb16, h16, tables,
                                 fnorm, gen, knob_sets=UNIT_KNOBS[1:2])))
    del mi8, mb16, h8, h16

    # real bf16 packs: against the plain versions and row by row
    fw = bf16_trunk(talker_t, gen)
    k1 = [check_k1_deep("talker bf16", talker_t, fw, 256, 200, gen, 20),
          check_k1_deep("talker bf16", talker_t, fw, 2560, 1800, gen, 5)]
    k4 = [check_k4_deep("talker bf16", talker_t, fw, 8, 512, gen, 10),
          check_k4_deep("talker bf16", talker_t, fw, 32, 512, gen, 3)]
    check_k4_equal("0.6B talker bf16", talker_t, fw, ((8, 256), (32, 2560)), gen, multi=False)
    bounds = {"K1": step_bound(talker_t, fw, 1, [200], 1, torch.bfloat16),
              "K4": step_bound(talker_t, fw, 8, [min(p, 511) for p in K4_POSITIONS], 1,
                               torch.bfloat16)}
    log(f"K1 0.6B talker bf16 units: {nbytes(fw) / 1e6:.1f} MB of pack per step, bound "
        f"{bounds['K1'][0]:.4f} ms ({bounds['K1'][1]}) [{CARD}]")
    del fw
    ts = dataclasses.replace(talker_t, num_layers=K1_SHALLOW_LAYERS)
    fws = bf16_trunk(ts, gen)
    for cache_dtype in (torch.float32, torch.bfloat16):
        for T, pos in ((256, 63), (512, 64), (2560, 2559)):
            k1.append(check_k1_shallow(f"talker-{K1_SHALLOW_LAYERS}-layer bf16", ts, fws, T, pos,
                                       cache_dtype, gen, 0))
        k4_shallow = check_k4_shallow(ts, fws, 8, 512, cache_dtype, gen)
        k4[0] = (max(k4[0][0], k4_shallow),) + k4[0][1:]
    del fws
    mfw = bf16_trunk(mtp_t, gen)
    heads = bf16_heads(cp, gen)
    k1.append(check_k1_deep("mtp-trunk bf16", mtp_t, mfw, 17, 9, gen, 20))
    chain = (cp, mfw, heads, tables, fnorm)
    # K3's limits: its 1.7B check's flip rule (a near-tie sub-code may flip)
    k3 = [check_chain("K3 0.6B bf16", K3.fused_mtp_chain_streamed,
                      K3.fused_mtp_chain_streamed_reference, knobs, *chain, gen, iters,
                      flip_rule=True)
          for knobs, iters in (((0.8, 50, 0.95), 10), ((0.0,), 0), ((1.0, 0, 1.0), 0))]
    k3_row = K3.fused_mtp_chain_streamed
    # against the plain chain at 8 and 16 rows (a plain chain of 32 rows takes
    # ~10 s); at 32 rows bit for bit against K3 below
    k5 = [check_k5(B, *chain, gen, iters, cache_dtype=torch.float32, row_chain=k3_row)
          for B, iters in ((8, 5), (16, 3))]
    check_k5_equal("0.6B MTP trunk bf16", *chain, gen, batches=(2, 8, 32),
                   cache_dtypes=(torch.float32,), multi=False, row_chain=k3_row)
    one_slot_ring(lambda: (
        check_k4_equal("0.6B MTP trunk bf16, one ring slot", mtp_t, mfw, ((5, 17), (32, 17)), gen,
                       multi=False),
        check_k5_equal("0.6B MTP trunk bf16, one ring slot", *chain, gen, batches=(8,),
                       cache_dtypes=(torch.float32,), multi=False, row_chain=k3_row)))
    bounds["K3"] = chain_bound(mtp_t, mfw, heads, 1)
    bounds["K5"] = chain_bound(mtp_t, mfw, heads, 8)
    del mfw, heads, tables
    torch.cuda.empty_cache()
    return k1, k4, k3, k5, bounds


def bf16_17b(tok, gen, card_line):
    """The 1.7B preset at B=1 with bf16 units: the anchors at its widths (K1
    and K3 on the wide slots' four 12 KB down rows), K1 and K3 against
    their plain versions on the engine's packs, the engine's instruct and
    preset-speaker requests and a fixed FIXED_FRAMES-frame run (one K1 and one K3
    per frame, 28 K8 per prefill); then B17: K4, K5 and K6 on the 48 KB batched
    plans (bf16_17b_batched_checks), ``synthesize_batch`` and a pool of 8 at
    bf16 and at int8 units, greedy ``spec_k=4`` against sequential decoding,
    and the server without ``--quantize``.  Returns (launch counts, the
    batched ones by report key, checks, bounds)."""
    cfg = voice_config()
    talker_t, cp = cfg.talker.transformer, cfg.code_predictor
    i8, b16 = unit_pair(talker_t, gen)
    check_unit_anchor_k1("1.7B talker", talker_t, i8, b16, ((256, 63), (1024, 1023)), gen)
    del i8, b16
    mi8, mb16 = unit_pair(cp.transformer, gen)
    h8, h16 = heads_pair(cp, gen)
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    check_unit_anchor_chains("1.7B MTP trunk", cp, mi8, h8, mb16, h16, tables, fnorm, gen,
                             batches=(), knob_sets=UNIT_KNOBS[:2])
    del mi8, mb16, h8, h16, tables
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    params["speaker_table"] = (torch.randn((len(PRESET_SPEAKERS), talker_t.hidden_size),
                                           generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok)
    torch.cuda.synchronize()
    if not eng.is_ready():
        raise RuntimeError(f"1.7B engine with quantize unset: {eng.get_error()}")
    plan = persistent.make_plan(talker_t, persistent.grid_size(DEV), unit_bytes=2)
    log(f"engine: 1.7B preset, quantize unset (bf16 units), built in "
        f"{time.perf_counter() - t0:.1f} s; one-row plan: {plan.n_slots} slots of "
        f"{plan.slot_bytes} bytes, stage rows {plan.stage_rows[:5]} [{card_line}]")
    fw = eng.params["talker"]["fused_step"]
    cpp = eng.params["code_predictor"]
    if fw.wqkv.dtype != torch.bfloat16 or b1_chain(eng) != "K3":
        raise RuntimeError("the 1.7B bf16 engine does not pack bf16 units or route B=1 to K3")
    check_k1_deep("talker-1.7B bf16", talker_t, fw, 256, 60, gen, 10)
    check_chain("K3 1.7B bf16", K3.fused_mtp_chain_streamed,
                K3.fused_mtp_chain_streamed_reference, (0.8, 50, 0.95), cp, cpp["fused_step"],
                cpp["fused_heads"], eng.params["embeddings"]["pred_embed"],
                cpp["transformer"]["final_norm"], gen, 5, flip_rule=True)
    checks, bounds = bf16_17b_batched_checks(cfg, eng, gen)
    layers = talker_t.num_layers
    reset_launches()
    decoded = 0
    for label, r in (
            ("synthesize(instruct)", eng.synthesize(
                VOICE_TEXT, language="en", temperature=0.8, top_k=50, top_p=0.95, max_tokens=48,
                seed=SEED, instruct=VOICE_INSTRUCT)),
            ("synthesize_speaker(serena)", eng.synthesize_speaker(
                "hello world, a preset speaker", "serena", language="en", temperature=0.0,
                max_tokens=48))):
        m = r.metrics
        decoded += m.decoded_frames
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"bad 1.7B bf16 {label} output")
        log(f"1.7B bf16 {label}: {m.frames} frames ({m.decoded_frames} decoded), "
            f"{m.stage_seconds['decode'] * 1e3 / max(m.decoded_frames, 1):.3f} ms/frame decode, "
            f"TTFA {m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
    counts = [check_launches(f"1.7B bf16 requests (one K1 and one K3 per decoded frame, {layers} "
                             "K8 per prefill)", counts_of(K1=decoded, K3=decoded, K8=2 * layers))]
    reset_launches()
    ms = check_fixed_run(eng, FIXED_FRAMES, [VOICE_TEXT], card_line, instruct=VOICE_INSTRUCT)
    counts.append(check_launches("1.7B bf16 fixed run",
                                 counts_of(K1=FIXED_FRAMES, K3=FIXED_FRAMES, K8=layers)))
    figure("1.7B B=1 ms/frame", ms)
    spec = TTSEngine(config=cfg, params=params, tokenizer=tok, spec_k=SPEC_K,
                     spec_iters=SPEC_ITERS, spec_accept_floor=0.0)
    i8 = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    with tempfile.TemporaryDirectory() as tmp:  # the server at the 1.7B preset's default
        d = os.path.join(tmp, "qwen3-tts-1.7b")
        save_checkpoint(d, cfg, params)
        byte_level_tokenizer(d)
        del params
        # B17's runs below while it boots (their times then share the card
        # with its warmup): batches, pools and spec at the 1.7B widths, bf16
        # units on the 48 KB batched plans, int8 units beside them (the
        # prefills add K8)
        server = start_servers(d, ((None, ()),))
        try:
            label = "1.7B bf16 (beside a booting server)"
            launched = {"K4 bf16 1.7B": batched_runs(eng, label, card_line)}
            # past 32 rows: two launches of 17 rows on the 48 KB plans, a few
            # frames
            launched["K4 bf16 1.7B"] = [a + b for a, b in zip(
                launched["K4 bf16 1.7B"], batch_rows_equal(eng, 34, label, card_line, frames=6))]
            for e in (spec, i8):
                if not e.is_ready():
                    raise RuntimeError(f"1.7B engine: {e.get_error()}")
            kw = dict(language="en", temperature=0.0, max_tokens=32)
            want = eng.synthesize(SPEC_TEXT, **kw)
            reset_launches()
            got = spec.synthesize(SPEC_TEXT, **kw)
            m = got.metrics
            it, k = m.spec_iterations, spec.spec_k
            seq = m.decoded_frames - 1 - it * k
            launched["K6 bf16 1.7B"] = check_launches(
                "1.7B bf16 spec_k=4 (K6 and K5 per iteration, K3 for frame 0 and after a "
                "fallback)",
                with_prefills(spec, counts_of(K1=seq + m.spec_fallback, K3=1 + seq, K5=it,
                                              K6=it)))
            equal = np.array_equal(got.codes, want.codes)
            log(f"1.7B bf16 spec_k=4: {len(got.codes)} frames, {it} iterations, codes equal to "
                f"sequential={equal} (K5's rows on K3's float32 cache), "
                f"{m.stage_seconds['decode'] * 1e3 / max(len(got.codes), 1):.3f} ms per "
                f"committed frame (beside a booting server) [{card_line}]")
            if not equal or it < 1:
                raise RuntimeError("1.7B bf16 spec: greedy codes differ from sequential decoding")
            del spec
            launched["1.7B int8"] = batched_runs(i8, "1.7B int8 (beside a booting server)",
                                                 card_line)
        except BaseException:
            finish_servers(server, None, kill=True)
            raise
        finish_servers(server, card_line)
    del eng, i8
    torch.cuda.empty_cache()
    counts += [launched["K4 bf16 1.7B"], launched["K6 bf16 1.7B"]]  # int8's: main's total
    return [sum(c) for c in zip(*counts)], launched, checks, bounds


def bf16_17b_batched_checks(cfg, eng, gen):
    """K4, K5 and K6 at bf16 units and the 1.7B widths (the batched plans'
    48 KB slots) on the engine's packs: K4 rows equal the K1 steps, K6 rows
    the K1 / K4 steps and K5 rows K3's chains (a float32 cache) bit for bit,
    each against its plain version (K5 at B=8; at B=32 its rows against
    K3's); a one-slot ring and a narrow one on two-layer packs.  Returns
    (checks by report key, bounds)."""
    talker_t, cp = cfg.talker.transformer, cfg.code_predictor
    fw = eng.params["talker"]["fused_step"]
    cpp = eng.params["code_predictor"]
    for B in (2, 8, 32):
        plan = persistent.make_plan(talker_t, persistent.grid_size(DEV), batch=B, unit_bytes=2)
        log(f"1.7B bf16 batched plan B={B}: {plan.n_slots} slots of {plan.slot_bytes} bytes, "
            f"{plan.groups} batch groups, stage rows {plan.stage_rows[:4]}, {plan.smem_bytes} "
            f"bytes of shared memory [{CARD}]")
    checks = {"K4 bf16 1.7B": [check_k4_deep("talker-1.7B bf16", talker_t, fw, 8, 512, gen, 5),
                               check_k4_deep("talker-1.7B bf16", talker_t, fw, 32, 512, gen, 1)],
              "K6 bf16 1.7B": [check_k6_deep("talker-1.7B bf16", talker_t, fw, 1, 4, 256, [200],
                                             gen, 10),
                               check_k6_deep("talker-1.7B bf16", talker_t, fw, 4, 8, 512,
                                             [60, 5, 504, 200], gen, 1)]}
    bounds = {"K4 bf16 1.7B": step_bound(talker_t, fw, 8, [min(p, 511) for p in K4_POSITIONS],
                                         1, torch.bfloat16),
              "K6 bf16 1.7B": checks["K6 bf16 1.7B"][0][3]}
    mfw, heads = cpp["fused_step"], cpp["fused_heads"]
    tables = eng.params["embeddings"]["pred_embed"]
    fnorm = cpp["transformer"]["final_norm"]
    chain = (cp, mfw, heads, tables, fnorm)
    k3_row = K3.fused_mtp_chain_streamed
    checks["K5 bf16 1.7B"] = [
        check_k5(8, *chain, gen, 3, cache_dtype=torch.float32, row_chain=k3_row)]
    check_k5_equal("1.7B MTP trunk bf16", *chain, gen, batches=(2, 32),
                   cache_dtypes=(torch.float32,), multi=False, row_chain=k3_row)
    bounds["K5 bf16 1.7B"] = chain_bound(cp.transformer, mfw, heads, 8)
    t2 = dataclasses.replace(talker_t, num_layers=2)
    fw2 = bf16_trunk(t2, gen)
    x4, kc4, vc4, pos = k4_inputs(t2, 8, 512, torch.bfloat16, gen)
    x6, kc6, vc6, starts = k6_inputs(t2, 4, 4, 512, [62, 5, 504, 130], torch.bfloat16, gen)
    pos_dev = torch.tensor(pos, device=DEV)

    def k4_once():
        c = clone_all([kc4, vc4])
        return (K1.fused_decode_step_batched(t2, fw2, x4, pos_dev, *c)[0], *c)

    def k6_once():
        c = clone_all([kc6, vc6])
        return (K6.fused_verify_step(t2, fw2, x6, starts, *c)[0], *c)

    ring_variants("K4 bf16 talker-1.7B-2-layer B=8", k4_once)
    ring_variants("K6 bf16 talker-1.7B-2-layer 4 x 4", k6_once)
    n, V, H = cp.num_steps, cp.subcode_vocab_size, cp.transformer.hidden_size
    lh = (torch.randn((8, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((8, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    noise = gumbel_noise((n, 8, V), gen, DEV)
    knobs = list(zip(*[K5_KNOBS[b % len(K5_KNOBS)] for b in range(8)]))
    ring_variants("K5 bf16 1.7B B=8 mixed knobs", lambda: K2.fused_mtp_chain_batched(
        cp.transformer, mfw, fnorm, heads, tables, lh, c0, noise, *knobs,
        cache_dtype=torch.float32))
    x, kc, vc, pos = k4_inputs(talker_t, 8, 512, torch.bfloat16, gen)
    pos_dev = torch.tensor(pos, device=DEV)
    trace_phases("K4 bf16 1.7B talker B=8 T=512",
                 K1._batch_entry(talker_t, fw, 8, 512, x.device).plan,
                 step_phase_names(talker_t.num_layers, batched=True),
                 lambda: K1.fused_decode_step_batched(talker_t, fw, x, pos_dev, kc, vc))
    del fw2, x, kc, vc, kc4, vc4, kc6, vc6
    torch.cuda.empty_cache()
    return checks, bounds


def bf16_phase(tok, gen, card_line):
    """Phase 12: ``quantize`` unset (bf16 units) on the card.  The anchors
    (bf16_anchors), then ``TTSEngine(config, params)`` at the 0.6B preset:
    three requests and a fixed FIXED_FRAMES-frame run (one K1 and one K3 per frame),
    ``frame_fused=True`` (the same: JAX's frame gate refuses bf16 trunks),
    ``synthesize_batch`` and fixed runs at B=8 and 32 and a pool of 8 (one K4
    and one K5 per frame, greedy pool output equal to B=1 ``synthesize``),
    then the 1.7B preset (bf16_17b: B=1, then its batches, pools, spec and
    server).  Prints each figure beside the int8 one of this run.  Returns
    (launch counts, checks, bounds, (the 1.7B batched launch counts and
    checks by report key))."""
    cfg = QWEN3_TTS_06B
    t_phase = time.perf_counter()
    k1, k4, k3, k5, bounds = bf16_anchors(cfg, gen)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok)
    ff_eng = TTSEngine(config=cfg, params=params, tokenizer=tok, frame_fused=True)
    del params
    torch.cuda.synchronize()
    for e in (eng, ff_eng):
        if not e.is_ready():
            raise RuntimeError(f"0.6B engine with quantize unset: {e.get_error()}")
    if eng.params["talker"]["fused_step"].wqkv.dtype != torch.bfloat16 or b1_chain(eng) != "K3":
        raise RuntimeError("the 0.6B bf16 engine does not pack bf16 units or route B=1 to K3")
    log(f"engines: 0.6B preset, random weights (seed {SEED}), quantize unset (bf16 units), "
        f"sequential and frame_fused, built in {time.perf_counter() - t0:.1f} s [{card_line}]")
    counts = []
    for label, e in (("sequential", eng), ("frame_fused=True", ff_eng)):
        reset_launches()
        decoded, ttfa = 0, []
        for req in B1_REQUESTS:
            r = e.synthesize(max_tokens=48, seed=SEED, **req)
            m = r.metrics
            decoded += m.decoded_frames
            ttfa.append(m.ttfa_seconds * 1e3)
            if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                    r.audio).all() or r.codes.shape[1:] != (16,) or m.frame_fused_frames:
                raise RuntimeError(f"bad bf16 synthesis output for {req} ({label})")
            decode_ms = m.stage_seconds["decode"] * 1e3 / max(m.decoded_frames, 1)
            log(f"bf16 {label} synthesize {req['language']} T={req['temperature']}: {m.frames} "
                f"frames ({m.decoded_frames} decoded), {decode_ms:.3f} ms/frame decode, RTF "
                f"{m.rtf:.2f}x, TTFA {m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
        ms = check_fixed_run(e, FIXED_FRAMES, [FIXED_TEXT], card_line)
        decoded += FIXED_FRAMES
        counts.append(check_launches(f"bf16 B=1 slice, {label} (one K1 and one K3 per decoded "
                                     "frame, no K2 or K7)", counts_of(K1=decoded, K3=decoded)))
        if e is eng:
            figure("0.6B B=1 ms/frame", ms)
            figure("0.6B B=1 TTFA ms (3 requests)", [round(x, 1) for x in ttfa])
    del ff_eng
    batched, ms = batched_phase(eng, card_line)
    batched_figures(ms)
    counts += [batched, pool_phase(eng, card_line)]
    del eng
    torch.cuda.empty_cache()
    c17, launched17, checks17, bounds17 = bf16_17b(tok, gen, card_line)
    counts.append(c17)
    log("bf16 units (quantize unset) beside int8, this run: " + "; ".join(
        f"{k}: int8 {v[0]}, bf16 {v[-1]}" for k, v in FIGURES.items()) + f" [{card_line}]")
    log(f"bf16 phase: {time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return [sum(c) for c in zip(*counts)], (k1, k4, k3, k5), bounds, (launched17, checks17,
                                                                       bounds17)


# ---------------------------------------------------------------------------
# Phase 13: the int8 KV cache (kv_quant=True)
# ---------------------------------------------------------------------------

# K1 on an int8 cache: (T, pos, timing iterations) at full depth, and the
# one-layer cases: the first slot, both sides of a split edge, the last slot
# of each bucket
KVQ_K1_DEEP_CASES = ((256, 200, 20), (2560, 2559, 5))
KVQ_K1_SHALLOW_CASES = ((256, 0), (256, 63), (256, 64), (256, 255), (2560, 1800), (2560, 2559))
# K6 on an int8 cache: (B, S, T, starts, timing iterations), K6_DEEP_CASES' shapes
KVQ_K6_CASES = ((1, 4, 256, [200], 20), (8, 3, 512, [0, 62, 63, 64, 509, 700, 130, 5], 5),
                (4, 8, 512, [60, 5, 504, 200], 3))
KVQ_K7_CASES = ((256, 255), (2560, 2559))
KVQ_POOL_TEXTS = ["hello world", "hello world, hello world", "a quick test of the pool",
                  "hello", "world", "hello hello", "the pool's seventh", "and its eighth"]


def q8_cache(t, B, T, filled, gen):
    """[k, v, k scale, v scale]: a seeded int8 cache [L, B, nk, T, d] on
    ``quantize_kv``'s grid with its float32 scales [L, B, nk, T], row b
    holding values before ``filled[b]`` and zeros from there."""
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    out = []
    for _ in range(2):
        x = torch.randn((L, B, nk, T, d), generator=gen, device=DEV) * 0.5
        for b, p in enumerate(filled):
            x[:, b, :, min(p, T):] = 0
        out.append(quantize_kv(x))
        del x
    (kq, ks), (vq, vs) = out
    return [kq, vq, ks, vs]


def clone_all(c):
    return [x.clone() for x in c]


def equal_all(a, b) -> bool:
    return len(a) == len(b) and all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def cache_slots(c, rows, slots):
    """The k and v of caches ``c`` at (rows, slots) as float32 [2, n, L, nk,
    d], dequantized on an int8 cache."""
    out = [c[i][:, rows, :, slots].float() for i in (0, 1)]
    if len(c) == 4:
        out = [o * c[2 + i][:, rows, :, slots][..., None] for i, o in enumerate(out)]
    return torch.stack(out)


def untouched_slots(after, before, written) -> bool:
    """Every slot (and scale) outside ``written`` [B, T] kept its bits."""
    keep = ~written[None, :, None, :]
    return all(bool(torch.equal(a.masked_select(keep if a.dim() == 4 else keep[..., None]),
                                b.masked_select(keep if b.dim() == 4 else keep[..., None])))
               for a, b in zip(after, before))


@dataclasses.dataclass
class Q8Run:
    """One seeded input through a kernel and its plain version on an int8
    cache (``rows``: the launch's rows, each with its written slot)."""

    err: float  # max |x_kernel - x_plain|
    rel: torch.Tensor  # [rows] max |dx| / max |x_plain|
    slot_err: float  # max |dequantized written slot, kernel - plain|
    slot_excess: float  # the same past one grid step (the larger of the two scales)
    q_equal: torch.Tensor  # [rows] the written int8 values equal
    scale_ulps: torch.Tensor  # [rows] the written scales' largest distance in ulps
    untouched: bool  # every other slot and scale as it was
    anchored: bool = True  # equal to the K1 / K4 steps it stands for, bit for bit


def q8_compare(xk, xp, ck, cp, base, rows, slots) -> Q8Run:
    B, T = base[0].shape[1], base[0].shape[3]
    written = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    written[rows, slots] = True
    dx = (xk - xp).abs().amax(dim=-1)
    diff = (cache_slots(ck, rows, slots) - cache_slots(cp, rows, slots)).abs()
    step = torch.maximum(ck[2][:, rows, :, slots], cp[2][:, rows, :, slots])
    step = torch.stack((step, torch.maximum(ck[3][:, rows, :, slots], cp[3][:, rows, :, slots])))
    q_equal = torch.ones(len(rows), dtype=torch.bool, device=DEV)
    ulps = torch.zeros(len(rows), device=DEV)
    for i in (0, 1):
        q_equal &= (ck[i][:, rows, :, slots] == cp[i][:, rows, :, slots]).flatten(1).all(1)
        a, b = ck[2 + i][:, rows, :, slots], cp[2 + i][:, rows, :, slots]
        ulp = torch.nextafter(b, torch.full_like(b, float("inf"))) - b
        ulps = torch.maximum(ulps, ((a - b).abs() / ulp).flatten(1).amax(1))
    torch.cuda.synchronize()
    return Q8Run(float(dx.max()), (dx / xp.abs().amax(dim=-1)).cpu(), float(diff.max()),
                 float((diff - step[..., None]).clamp(min=0).max()), q_equal.cpu(), ulps.cpu(),
                 untouched_slots(ck, base, written))


def kvq_k1_run(t, fw, T, pos, gen):
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    base = q8_cache(t, 1, T, [pos], gen)
    ck, cp = clone_all(base), clone_all(base)
    xk = K1.fused_decode_step(t, fw, x, pos, *ck)[0]
    xp = K1.fused_decode_step_reference(t, fw, x, pos, *cp)[0]
    idx = torch.tensor([0], device=DEV), torch.tensor([pos], device=DEV)
    return q8_compare(xk, xp, ck, cp, base, *idx), x, base


def kvq_k4_run(t, fw, B, T, gen):
    """K4 on one seeded batch (K4_POSITIONS' rows) against its plain version,
    and every row against K1 on it, bit for bit (x, values and scales)."""
    pos = [K4_POSITIONS[b % len(K4_POSITIONS)] for b in range(B)]
    x = torch.randn((B, t.hidden_size), generator=gen, device=DEV) * 0.3
    base = q8_cache(t, B, T, [min(p, T - 1) for p in pos], gen)
    pos_dev = torch.tensor(pos, device=DEV)
    ck, cp = clone_all(base), clone_all(base)
    xk = K1.fused_decode_step_batched(t, fw, x, pos_dev, *ck)[0]
    xp = K1.fused_decode_step_batched_reference(t, fw, x, pos_dev, *cp)[0]
    r = q8_compare(xk, xp, ck, cp, base, torch.arange(B, device=DEV),
                   torch.clamp(pos_dev, max=T - 1))
    del cp
    for b, p in enumerate(pos):
        c1 = [c[:, b : b + 1].clone() for c in base]
        x1 = K1.fused_decode_step(t, fw, x[b : b + 1], p, *c1)[0]
        r.anchored &= bool(torch.equal(x1[0], xk[b])) and equal_all(
            [c[:, 0] for c in c1], [c[:, b] for c in ck])
    return r, (x, pos_dev, base)


def kvq_k6_run(t, fw, B, S, T, starts, gen, stall_ns=0):
    """K6 on one seeded batch against its plain version, and against the S
    successive K1 (B=1) or K4 steps it stands for, bit for bit; with
    ``stall_ns`` every slot write of K6 first waits that long (see
    check_k6_equal)."""
    x = torch.randn((B, S, t.hidden_size), generator=gen, device=DEV) * 0.3
    base = q8_cache(t, B, T, [min(p, T - S) for p in starts], gen)
    pos_dev = torch.tensor(starts, device=DEV)
    ck, cp = clone_all(base), clone_all(base)
    plan = None
    if stall_ns:
        plan = K6._verify_entry(t, fw, B, S, T, torch.int8,
                                torch.device("cuda", torch.cuda.current_device())).plan
        plan.struct.write_stall_ns = stall_ns
    try:
        xk = K6.fused_verify_step(t, fw, x, pos_dev, *ck)[0]
    finally:
        if plan is not None:
            plan.struct.write_stall_ns = 0
    xp = K6.fused_verify_step_reference(t, fw, x, pos_dev, *cp)[0]
    first = torch.clamp(pos_dev, 0, T - S)
    slots = (first[:, None] + torch.arange(S, device=DEV)).flatten()
    rows = torch.arange(B, device=DEV).repeat_interleave(S)
    H = t.hidden_size
    r = q8_compare(xk.reshape(B * S, H), xp.reshape(B * S, H), ck, cp, base, rows, slots)
    del cp
    c1 = clone_all(base)
    for s in range(S):
        if B == 1:
            x1 = K1.fused_decode_step(t, fw, x[:, s], int(first[0]) + s, *c1)[0]
        else:
            x1 = K1.fused_decode_step_batched(t, fw, x[:, s], first + s, *c1)[0]
        r.anchored &= bool(torch.equal(x1, xk[:, s]))
    r.anchored &= equal_all(c1, ck)
    return r, (x, pos_dev, base)


def check_q8(label, runs, deep):
    """The limits of K1's checks on int8-cache runs: deep, x within
    K1_DEEP_X_REL and each written slot (dequantized) within
    K1_DEEP_SLOT_ABS past one grid step; shallow, the one-layer limits and
    K1_TIGHT_MIN of every K1_TIGHT_INPUTS rows tight (x within K1_TIGHT_REL
    and the written int8 values equal); every other slot and scale
    untouched and every anchor bit for bit.  The written scales are amax /
    127 of values the kernel and the plain version sum in other orders, so
    they agree to a few ulps (printed), not bit for bit; on exact ties
    (check_kvq_ties) they agree bit for bit."""
    rel = max(float(r.rel.max()) for r in runs)
    excess = max(r.slot_excess for r in runs)
    slot_err = max(r.slot_err for r in runs)
    untouched = all(r.untouched for r in runs)
    anchored = all(r.anchored for r in runs)
    rels = torch.cat([r.rel for r in runs])
    q_equal = torch.cat([r.q_equal for r in runs])
    tight = int(((rels <= K1_TIGHT_REL) & q_equal).sum())
    rows = len(rels)
    x_tol, slot_tol = ((K1_DEEP_X_REL, K1_DEEP_SLOT_ABS) if deep
                       else (K1_SHALLOW_X_REL, K1_SHALLOW_SLOT_ABS))
    need = 0 if deep else K1_TIGHT_MIN * rows // K1_TIGHT_INPUTS
    ok = rel < x_tol and excess < slot_tol and untouched and anchored and tight >= need
    quart = [f"{float(v):.1e}" for v in torch.quantile(rels.double(), torch.tensor(
        [0.25, 0.5, 0.75], dtype=torch.float64))]
    log(f"{label}: {len(runs)} input(s), x max row rel {rel:.3e} (tol {x_tol}; quartiles "
        f"{quart}) slot max_abs_err {slot_err:.3e}, past one grid step {excess:.3e} (tol "
        f"{slot_tol}) int8 slots equal {int(q_equal.sum())}/{rows}, scales within "
        f"{float(torch.cat([r.scale_ulps for r in runs]).max()):.0f} ulps; tight rows (x rel <= "
        f"{K1_TIGHT_REL}, int8 slot equal) {tight}/{rows} (need {need}) "
        f"untouched_slots_and_scales_equal={untouched} anchors_bit_for_bit={anchored} -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"{label}: the int8-cache kernel disagrees with its plain version or "
                           "its anchors")
    return max(r.err for r in runs)


def check_kvq_k1(name, t, fw, T, pos, gen, inputs, iters):
    runs = [kvq_k1_run(t, fw, T, pos, gen) for _ in range(inputs)]
    err = check_q8(f"K1 kvq {name}: L={t.num_layers} T={T} pos={pos}", [r for r, _, _ in runs],
                   deep=inputs == 1)
    ms = plain_ms = float("nan")
    if iters:
        _, x, base = runs[0]
        ck, cp = clone_all(base), clone_all(base)
        ms = time_ms(lambda: K1.fused_decode_step(t, fw, x, pos, *ck), iters)
        plain_ms = time_ms(lambda: K1.fused_decode_step_reference(t, fw, x, pos, *cp), 3, 1)
        log(f"K1 kvq {name} T={T} pos={pos}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{CARD}]")
    return err, ms, plain_ms


def check_kvq_k4(name, t, fw, B, T, gen, iters):
    r, (x, pos_dev, base) = kvq_k4_run(t, fw, B, T, gen)
    err = check_q8(f"K4 kvq {name}: L={t.num_layers} B={B} T={T} (rows against K1 kvq)", [r],
                   deep=True)
    ms = plain_ms = float("nan")
    if iters:
        ck, cp = clone_all(base), clone_all(base)
        ms = time_ms(lambda: K1.fused_decode_step_batched(t, fw, x, pos_dev, *ck), iters)
        plain_ms = time_ms(lambda: K1.fused_decode_step_batched_reference(t, fw, x, pos_dev, *cp),
                           1, 0)
        log(f"K4 kvq {name} B={B} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{CARD}]")
    return err, ms, plain_ms


def check_kvq_k6(name, t, fw, B, S, T, starts, gen, iters, stall_ns=0):
    r, (x, pos_dev, base) = kvq_k6_run(t, fw, B, S, T, starts, gen, stall_ns)
    stalled = f", writes stalled {stall_ns} ns" if stall_ns else ""
    err = check_q8(f"K6 kvq {name}: L={t.num_layers} B={B} S={S} T={T} starts={starts} (rows "
                   f"against the {'K1' if B == 1 else 'K4'} kvq steps{stalled})", [r], deep=True)
    ms = plain_ms = float("nan")
    if iters:
        ck, cp = clone_all(base), clone_all(base)
        ms = time_ms(lambda: K6.fused_verify_step(t, fw, x, pos_dev, *ck), iters)
        plain_ms = time_ms(lambda: K6.fused_verify_step_reference(t, fw, x, pos_dev, *cp), 1, 0)
        log(f"K6 kvq {name} B={B} S={S} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"[{CARD}]")
    return err, ms, plain_ms


def check_kvq_units(name, t, i8, b16, gen):
    """K1 (T=256 and 2560) and K4 (B=8 and 32, T=512) on the bf16 twin of an
    int8 pack with unit scales against the int8 pack, on an int8 cache: x,
    values and scales equal bit for bit.  Returns the steps compared."""
    equal = total = 0
    for T, pos in ((256, 63), (2560, 2559)):
        x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
        base = q8_cache(t, 1, T, [pos], gen)
        c8, cb = clone_all(base), clone_all(base)
        same = bool(torch.equal(K1.fused_decode_step(t, i8, x, pos, *c8)[0],
                                K1.fused_decode_step(t, b16, x, pos, *cb)[0]))
        equal += same and equal_all(c8, cb)
        total += 1
    for B in (8, 32):
        pos = torch.tensor([K4_POSITIONS[b % len(K4_POSITIONS)] for b in range(B)], device=DEV)
        x = torch.randn((B, t.hidden_size), generator=gen, device=DEV) * 0.3
        base = q8_cache(t, B, 512, torch.clamp(pos, max=511).tolist(), gen)
        c8, cb = clone_all(base), clone_all(base)
        same = bool(torch.equal(K1.fused_decode_step_batched(t, i8, x, pos, *c8)[0],
                                K1.fused_decode_step_batched(t, b16, x, pos, *cb)[0]))
        equal += same and equal_all(c8, cb)
        total += 1
        del base, c8, cb
    ok = equal == total
    log(f"K1 / K4 bf16 units vs int8 units on an int8 KV cache, {name}: K1 (T, pos) ((256, 63), "
        f"(2560, 2559)), K4 B 8 and 32 at T=512: {equal}/{total} steps equal bit for bit (x, "
        f"values, scales) -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"bf16 units differ from int8 units on an int8 KV cache ({name})")
    return total


def check_kvq_ties(t, gen):
    """The quantization's rounding on exact ties, through the kernels: a
    one-layer pack whose v rows read only the first input column (an int8
    one) at per-row scales (127, k + 1/2, ...) / 8, and x = ones, so that
    bf16(RMSNorm(x)) = 1 and each head's v is that row of scales: amax / 127
    = 1/8 and v / scale = k + 1/2 exactly.  K1, K4 (2 rows) and K6 (2
    candidates, the slot-write phase) write the plain version's int8 v
    values (half to even) and v scales bit for bit."""
    fw = packed_trunk(t, gen)
    v0, d = t.q_dim + t.kv_dim, t.head_dim
    w, sc = fw.wqkv.clone(), fw.sqkv.clone()
    w[:, v0:] = 0
    w[:, v0:, 0] = 1
    row = torch.tensor([127.0] + [(j * 37) % 61 - 30 + 0.5 for j in range(1, d)], device=DEV)
    sc[:, v0:] = (row / 8).repeat(t.num_kv_heads)
    fw = fw._replace(wqkv=w, sqkv=sc)
    H, T = t.hidden_size, 256
    results = []
    for what, B, S, pos in (("K1", 1, 0, 77), ("K4", 2, 0, [5, 130]), ("K6", 1, 2, [63])):
        base = q8_cache(t, B, T, pos if isinstance(pos, list) else [pos], gen)
        ck, cp = clone_all(base), clone_all(base)
        if what == "K1":
            x = torch.ones((1, H), device=DEV)
            K1.fused_decode_step(t, fw, x, pos, *ck)
            K1.fused_decode_step_reference(t, fw, x, pos, *cp)
        elif what == "K4":
            x, p = torch.ones((B, H), device=DEV), torch.tensor(pos, device=DEV)
            K1.fused_decode_step_batched(t, fw, x, p, *ck)
            K1.fused_decode_step_batched_reference(t, fw, x, p, *cp)
        else:
            x, p = torch.ones((B, S, H), device=DEV), torch.tensor(pos, device=DEV)
            K6.fused_verify_step(t, fw, x, p, *ck)
            K6.fused_verify_step_reference(t, fw, x, p, *cp)
        torch.cuda.synchronize()
        # the plain version's slot (row 0's first write) holds the ties' even neighbours
        slot = pos[0] if isinstance(pos, list) else pos
        v8, vs = cp[1][0, 0, :, slot], cp[3][0, 0, :, slot]
        if not (torch.equal(v8, torch.round(row).to(torch.int8).expand_as(v8))
                and bool((vs == 0.125).all())):
            raise RuntimeError(f"{what}: the tie input did not make ties (plain slot {v8[0, :4]})")
        # v's int8 values and scales (k's pass through a random product)
        results.append((what, torch.equal(ck[1], cp[1]) and torch.equal(ck[3], cp[3])))
        del base, ck, cp
    ok = all(e for _, e in results)
    log(f"int8 KV quantization on exact ties (v / scale = k + 1/2): "
        + ", ".join(f"{w} writes the plain version's int8 v and v scales bit for bit {e}"
                    for w, e in results) + f" -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError("the int8 KV quantization rounds a tie otherwise than half to even")


def kvq_one_slot(t, fw, i8, b16, packs, gen):
    """The bit-for-bit anchors of the int8-cache kernels with every
    persistent plan on one ring slot: K4 rows against K1, K6 against its
    K4 steps, the bf16-unit twins, and K7 against its composition."""
    r4, _ = kvq_k4_run(t, fw, 8, 512, gen)
    r6, _ = kvq_k6_run(t, fw, 4, 8, 512, [60, 5, 504, 200], gen)
    ok = r4.anchored and r6.anchored and r4.untouched and r6.untouched
    log(f"int8 KV cache, one ring slot: K4 B=8 rows equal K1 {r4.anchored}, K6 4 x 8 equal its K4 "
        f"steps {r6.anchored} [{CARD}]")
    if not ok:
        raise RuntimeError("int8 KV cache, one ring slot: an anchor differs")
    check_kvq_units("0.6B talker, one ring slot", t, i8, b16, gen)
    check_k7_composition(packs, 256, 255, torch.int8, gen, inputs=1)


def kvq_engine_runs(tok, card_line):
    """The 0.6B engines with kv_quant=True: B=1 fixed runs in turns with a
    bf16 cache (int8 and bf16 units), greedy B=1 against spec_k=4,
    frame_fused, spec_k=4 at full and zero acceptance, synthesize_batch at
    B=8 and 32 and a pool of 8 (int8 and bf16 units; greedy pool output
    equal to B=1).  Returns the kvq launch counts."""
    cfg = QWEN3_TTS_06B
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    kw = dict(config=cfg, params=params, tokenizer=tok)
    q8 = TTSEngine(**kw, quantize="int8", kv_quant=True)
    qb = TTSEngine(**kw, kv_quant=True)
    refs = {"int8": TTSEngine(**kw, quantize="int8"), "bf16": TTSEngine(**kw)}
    ff = TTSEngine(**kw, quantize="int8", kv_quant=True, frame_fused=True)
    spec = TTSEngine(**kw, quantize="int8", kv_quant=True, spec_k=SPEC_K, spec_iters=SPEC_ITERS,
                     spec_accept_floor=0.0)
    del params, kw
    for e in (q8, qb, ff, spec, *refs.values()):
        if not e.is_ready():
            raise RuntimeError(f"0.6B engine: {e.get_error()}")
    for e in (q8, qb, ff, spec):
        c = e.cfg.talker.transformer
        if not c.kv_cache_quant or e.cfg.code_predictor.transformer.kv_cache_quant:
            raise RuntimeError("kv_quant must set the talker's int8 cache, and only the talker's")
    log(f"engines: 0.6B preset, kv_quant=True (int8 and bf16 units, frame_fused, spec_k={SPEC_K}) "
        f"and a bf16 cache; KV ladder {q8.kv_ladder} [{card_line}]")
    counts = []
    for units, e in (("int8", q8), ("bf16", qb)):
        ref, chain = refs[units], b1_chain(e)
        ms = {}
        for label, eng in (("bf16 cache", ref), ("int8 cache", e), ("int8 cache", e),
                           ("bf16 cache", ref)):
            reset_launches()
            ms.setdefault(label, []).append(check_fixed_run(eng, FIXED_FRAMES, [FIXED_TEXT],
                                                            card_line))
            got = check_launches(f"fixed run B=1, {units} units, {label}",
                                 counts_of(K1=FIXED_FRAMES, **{chain: FIXED_FRAMES}))
            if eng is e:
                counts.append(got)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        log(f"0.6B B=1 fixed run, {units} units, in turns (bf16 cache, int8 cache, int8 cache, "
            f"bf16 cache): bf16 cache {ms['bf16 cache']} int8 cache {ms['int8 cache']} ms/frame; "
            f"means {mean['int8 cache']:.4f} vs {mean['bf16 cache']:.4f} ms/frame (int8 / bf16 "
            f"{mean['int8 cache'] / mean['bf16 cache']:.4f}) [{card_line}]")
    del refs
    # greedy B=1 with the int8 cache equals spec_k=4 greedy (the JAX tests' pin)
    counts.append(check_spec_engine("kvq B=1 repeat draft", q8, spec, card_line))
    reset_launches()
    r = ff.synthesize(FIXED_TEXT, language="en", temperature=0.0, max_tokens=48)
    n = r.metrics.decoded_frames
    if r.metrics.frame_fused_frames != n or not np.isfinite(r.audio).all():
        raise RuntimeError("kvq frame_fused: a frame left K7, or bad audio")
    counts.append(check_launches("kvq frame_fused synthesize (one K7 per frame)", counts_of(K7=n)))
    reset_launches()
    ff_ms = check_fixed_run(ff, FIXED_FRAMES, [FIXED_TEXT], card_line)
    counts.append(check_launches("kvq frame_fused fixed run", counts_of(K7=FIXED_FRAMES)))
    log(f"kvq frame_fused fixed run: {ff_ms:.3f} ms/frame [{card_line}]")
    sampled = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    for label, force in (("full acceptance (force_accept)", True), ("repeat draft", False)):
        reset_launches()
        _, it, decode_s, decoded = spec_fixed_run(spec, FIXED_FRAMES, sampled, [SPEC_TEXT],
                                                  repeat_draft, force)
        counts.append(check_launches(f"kvq spec fixed run, {label}", (0, 1, 0, it, it)))
        log(f"kvq spec fixed run B=1 k={SPEC_K}, {label}: {decoded} frames in {it} iterations, "
            f"{decode_s * 1e3 / decoded:.3f} ms per committed frame [{card_line}]")
    del ff, spec
    for units, e in (("int8", q8), ("bf16", qb)):
        for B in (8, 32):
            texts = [BATCH_TEXTS[b % len(BATCH_TEXTS)] for b in range(B)]
            reset_launches()
            t0 = time.perf_counter()
            results = e.synthesize_batch(texts, language="en", temperature=0.8, top_k=50,
                                         top_p=0.95, max_tokens=48, seed=list(range(B)))
            wall = time.perf_counter() - t0
            decoded = results[0].metrics.decoded_frames
            if any(not np.isfinite(r.audio).all() or r.codes.shape[1:] != (16,) for r in results):
                raise RuntimeError(f"kvq synthesize_batch B={B}: bad output")
            counts.append(check_launches(f"kvq synthesize_batch B={B}, {units} units",
                                         counts_of(K4=decoded, K5=decoded)))
            log(f"kvq synthesize_batch B={B}, {units} units: {decoded} batched frames, "
                f"{results[0].metrics.stage_seconds['decode'] * 1e3 / decoded:.3f} ms per batched "
                f"frame decode, aggregate RTF "
                f"{sum(r.metrics.audio_seconds for r in results) / wall:.2f}x [{card_line}]")
        pool = ContinuousBatcher(e, pool_size=8, chunk_len=16, kv_bucket=e.kv_ladder[0])
        try:
            reset_launches()
            c0 = pool.stats["chunks"]
            futs = [pool.submit(t, language="en", temperature=0.8, max_tokens=16, seed=SEED + i)
                    for i, t in enumerate(KVQ_POOL_TEXTS)]
            for f in futs:
                r = f.result(timeout=600)
                if not np.isfinite(r.audio).all() or not 0 < len(r.codes) <= 16:
                    raise RuntimeError("kvq pool: bad result")
            text = "hello world, greedy through the pool"
            got = pool.synthesize(text, language="en", temperature=0.0, max_tokens=32)
            n = 16 * (pool.stats["chunks"] - c0)
            counts.append(check_launches(f"kvq pool of 8, {units} units", counts_of(K4=n, K5=n)))
            want = e.synthesize(text, language="en", temperature=0.0, max_tokens=32)
            equal = np.array_equal(got.codes, want.codes)
            log(f"kvq pool of 8, {units} units: {len(KVQ_POOL_TEXTS)} requests, {n} pooled frames; "
                f"greedy output equal to B=1 synthesize={equal} [{card_line}]")
            if not equal:
                raise RuntimeError("kvq pool: greedy output differs from B=1 synthesize")
        finally:
            pool.shutdown()
    del q8, qb
    torch.cuda.empty_cache()
    return [sum(c) for c in zip(*counts)]


def kvq_17b(tok, gen, card_line):
    """The 1.7B preset at B=1 with kv_quant=True and int8 units: K1 kvq at the
    1.7B talker's widths (T=256) against its plain version, then an instruct
    request and a fixed FIXED_FRAMES-frame run (one K1 and one K3 per frame, K8 on the
    dequantized K/V in every prefill).  Returns the launch counts and the K1
    check."""
    cfg = voice_config()
    t = cfg.talker.transformer
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8", kv_quant=True)
    del params
    if not eng.is_ready():
        raise RuntimeError(f"1.7B kv_quant engine: {eng.get_error()}")
    k1 = check_kvq_k1("talker-1.7B", t, eng.params["talker"]["fused_step"], 256, 60, gen, 1, 0)
    layers = t.num_layers
    reset_launches()
    r = eng.synthesize(VOICE_TEXT, language="en", temperature=0.8, top_k=50, top_p=0.95,
                       max_tokens=48, seed=SEED, instruct=VOICE_INSTRUCT)
    n = r.metrics.decoded_frames
    if not np.isfinite(r.audio).all() or r.codes.shape[1:] != (16,):
        raise RuntimeError("1.7B kvq synthesize(instruct): bad output")
    counts = [check_launches("1.7B kvq synthesize(instruct)", counts_of(K1=n, K3=n, K8=layers))]
    reset_launches()
    check_fixed_run(eng, FIXED_FRAMES, [VOICE_TEXT], card_line, instruct=VOICE_INSTRUCT)
    counts.append(check_launches("1.7B kvq fixed run",
                                 counts_of(K1=FIXED_FRAMES, K3=FIXED_FRAMES, K8=layers)))
    del eng
    torch.cuda.empty_cache()
    return [sum(c) for c in zip(*counts)], k1


def kvq_phase(tok, gen, card_line):
    """Phase 13: the int8 KV cache (``kv_quant=True``).  K1, K4, K6 and K7 on
    int8 caches against their plain versions and their anchors, then the
    engines (kvq_engine_runs) and the 1.7B preset (kvq_17b).  Returns
    (launch counts, checks of K1, K4, K6, K7, bounds)."""
    t0 = time.perf_counter()
    cfg = QWEN3_TTS_06B
    t = cfg.talker.transformer
    fw = packed_trunk(t, gen)
    k1 = [check_kvq_k1("talker", t, fw, T, pos, gen, 1, iters)
          for T, pos, iters in KVQ_K1_DEEP_CASES]
    k4 = [check_kvq_k4("talker", t, fw, B, 512, gen, iters) for B, iters in ((8, 10), (32, 3))]
    k6 = [check_kvq_k6("talker", t, fw, B, S, T, starts, gen, iters)
          for B, S, T, starts, iters in KVQ_K6_CASES]
    # every slot write stalled: the slot-write phase's barrier must hold the
    # readers of the new values and scales (check_k6_equal's stall)
    for case in K6_STALL_CASES:
        check_kvq_k6("talker", t, fw, *case, gen, 0, stall_ns=K6_STALL_NS)
    bounds = {"K1 kvq": step_bound(t, fw, 1, [200], 1, torch.int8),
              "K4 kvq": step_bound(t, fw, 8, [min(p, 511) for p in K4_POSITIONS], 1, torch.int8),
              "K6 kvq": step_bound(t, fw, 4, [200], 4, torch.int8)}
    ts = dataclasses.replace(t, num_layers=K1_SHALLOW_LAYERS)
    fws = packed_trunk(ts, gen)
    for T, pos in KVQ_K1_SHALLOW_CASES:
        k1.append(check_kvq_k1(f"talker-{K1_SHALLOW_LAYERS}-layer", ts, fws, T, pos, gen,
                               K1_TIGHT_INPUTS, 0))
    del fws
    check_kvq_ties(ts, gen)
    i8, b16 = unit_pair(t, gen)
    check_kvq_units("0.6B talker", t, i8, b16, gen)
    packs = frame_packs(cfg, gen)
    for T, pos in KVQ_K7_CASES:
        check_k7_composition(packs, T, pos, torch.int8, gen, inputs=4)
    k7 = [check_k7_plain(packs, 256, 255, K7_KNOBS[1], gen, 20, torch.int8)]
    k7 += [check_k7_plain(packs, T, pos, knobs, gen, 0, torch.int8)
           for T, pos in KVQ_K7_CASES for knobs in K7_KNOBS[:2] if (T, knobs) != (256, K7_KNOBS[1])]
    bounds["K7 kvq"] = frame_bound(packs, 255, torch.int8)
    one_slot_ring(lambda: kvq_one_slot(t, fw, i8, b16, packs, gen))
    del fw, i8, b16, packs
    torch.cuda.empty_cache()
    for key, (ms, by) in bounds.items():
        log(f"{key} bound {ms:.4f} ms ({by}): weights, the int8 slots and their scales read "
            f"[{CARD}]")
    log(f"int8 KV cache kernel checks: {time.perf_counter() - t0:.1f} s [{card_line}]")
    counts = kvq_engine_runs(tok, card_line)
    c17, k1_17 = kvq_17b(tok, gen, card_line)
    k1.append(k1_17)
    log(f"int8 KV cache phase: {time.perf_counter() - t0:.1f} s [{card_line}]")
    return [sum(c) for c in zip(counts, c17)], (k1, k4, k6, k7), bounds


# ---------------------------------------------------------------------------
# Phase 14: the tensor-parallel decode path (kernels K9 and K10) on a mesh that
# lists this card tp times: tp logical ranks, each with its shard, its kv
# heads and its exchange buffers, all on the one card.
# ---------------------------------------------------------------------------

TP_MODELS = (("0.6B", QWEN3_TTS_06B, 2), ("1.7B", QWEN3_TTS_17B, 4))
K9_CASES = ((256, 200), (2560, 2559))
# K9 against K1 bit for bit: at tp=1 (the shard is the whole tensor), and
# with every peer's rows zero (rank 0's result is K1's on rank 0's shard)
K9_EQUAL_CASES = ((256, 200), (2560, 1800))
# K9 on one layer against its plain version (the JAX halves' unit products
# and the hypercube's sum): the same bf16 operands summed in other orders, so
# most inputs agree to ~1e-7 and a GEMV input on a bf16 rounding edge moves x
# by up to ~1e-3 relative; a wrong row, scale, slot or exchange moves it by
# O(1).  Each case runs K1's count of seeded inputs, all within K1's
# flip-tolerant limits, and needs K1's count of them within K1_TIGHT_REL (at
# the 1.7B widths, T=2560, a bf16 cache: 8 and 2 of 8 inputs tight in two
# runs, so 3 of 8 failed the real kernel).
K9_ONE_LAYER_INPUTS = K1_TIGHT_INPUTS
K9_TIGHT_MIN = K1_TIGHT_MIN
K10_STALL_NS = 20_000  # odd ranks hold every exchange's send back this long (K9 and K10)
# the planted timeout: odd ranks' sends held past the even ranks' wait limit
K10_TIMEOUT_STALL_NS = 2_000_000
K10_TIMEOUT_NS = 200_000
K10_KNOBS = ((0.0,), (0.8, 50, 0.95), (1.0, 0, 1.0))
ROW_LEAVES = ("wqkv", "sqkv", "wo", "so", "wgu", "sgu", "wd", "sd")


def card_devices(tp, first=0):
    """A mesh's model devices: this card tp times (logical ranks), or tp
    cards from ``first`` on."""
    return [torch.device("cuda", first)] * tp


def tp_pack(t, tp, mesh, gen):
    """Random raw layers of ``t`` (seeded), packed per rank as the JAX
    package packs them and turned into the ranks' row packs (what K9 and
    K10 take)."""
    layers = init_transformer_params(t, gen, DEV)["layers"]
    rows = K9.pack_rows(t, tp, K9.pack_fused_tp(t, layers, tp, mesh=mesh))
    del layers
    return rows


def random_scales(rows, gen):
    """The row packs with every row's scale drawn anew (0.5x to 1.5x)."""
    def draw(s):
        return s * (0.5 + torch.rand(s.shape, generator=gen, device=s.device))

    return K9.FusedTPRows([w._replace(**{k: draw(getattr(w, k)) for k in ("sqkv", "so", "sgu",
                                                                         "sd")})
                           for w in rows.ranks])


def rows_bytes(rows, names=None) -> int:
    """Bytes of every rank's leaves ``names`` (all of them by default)."""
    return sum(nbytes([getattr(w, k) for k in (names or w._fields)]) for w in rows.ranks)


def tp_caches(t, tp, T, pos, cache_dtype, gen, devices):
    """Seeded per-rank caches [L, 1, nk / tp, T, d] with the slots from pos on zeroed."""
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    out = []
    for _ in range(2):
        c = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
        c[:, :, :, pos:] = 0
        out.append(K9.split_heads(c, devices))
    return out


def statuses(run) -> list:
    """Every rank's status word of a K9 or K10 run, in rank order."""
    return [int(v) for words in run.status for v in words.tolist()]


def step_tp_bound(t, tp, rows, pos, cache_dtype):
    """Bound of one K9 step: every rank's rows, scales and norms read once
    (the ranks share the card's HBM), the slots it attends over every layer,
    the new slot and x written; the products' and the attention's
    multiply-adds."""
    elem = torch.empty((), dtype=cache_dtype).element_size()
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    moved = rows_bytes(rows) + 2 * L * nk * d * elem * (pos + 2) + 2 * t.hidden_size * 4
    macs = rows_bytes(rows, ("wqkv", "wo", "wgu", "wd"))  # int8: 1 byte a multiply-add
    return bound(moved, 2 * macs + L * 4 * t.num_heads * d * (pos + 1))


def check_k9_step(name, t, tp, rows, mesh, T, pos, gen, iters=0):
    """The whole step (one launch for the card's ranks) against the step on
    the plain halves, bf16 cache, K1's deep limits; every rank's residual
    the same bits, no exchange timed out.  Returns (max abs error, ms per
    step, plain ms per step)."""
    devices = mesh.model_devices()
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc, vc = tp_caches(t, tp, T, pos, torch.bfloat16, gen, devices)
    kk, vk = [c.clone() for c in kc], [c.clone() for c in vc]
    kp, vp = [c.clone() for c in kc], [c.clone() for c in vc]
    run = K9.launch_step_tp(t, rows, x, pos, kk, vk, mesh)
    xp, _, _ = K9.fused_decode_step_tp_reference(t, rows, x, pos, kp, vp, mesh)
    torch.cuda.synchronize()
    xk = run.x
    ranks_equal = all(torch.equal(v.to(DEV), xk[0]) for v in run.xs)
    status = statuses(run)
    err = float((xk - xp).abs().max())
    rel = err / float(xp.abs().max())
    slot_err = max(float((a[:, :, :, pos].float() - b[:, :, :, pos].float()).abs().max())
                   for a, b in zip(kk + vk, kp + vp))
    others = torch.ones(T, dtype=torch.bool, device=DEV)
    others[pos] = False
    untouched = all(bool(torch.equal(a[:, :, :, others], b[:, :, :, others]))
                    for a, b in zip(kk + vk, kc + vc))
    ms = plain_ms = float("nan")
    if iters:
        ms = time_ms(lambda: K9.fused_decode_step_tp(t, rows, x, pos, kk, vk, mesh), iters)
        K9.check_timeouts()
        plain_ms = time_ms(lambda: K9.fused_decode_step_tp_reference(t, rows, x, pos, kp, vp, mesh),
                           1, 0)
    ok = (rel < K1_DEEP_X_REL and slot_err < K1_DEEP_SLOT_ABS and untouched and ranks_equal
          and not any(status))
    log(f"K9 step {name}: L={t.num_layers} tp={tp} T={T} pos={pos} cache=bfloat16 x "
        f"max_abs_err={err:.3e} rel={rel:.3e} (tol {K1_DEEP_X_REL}) slot max_abs_err="
        f"{slot_err:.3e} (tol {K1_DEEP_SLOT_ABS}) untouched_slots_equal={untouched} every "
        f"rank's x equal={ranks_equal} status={status} kernel {ms:.4f} ms/step plain "
        f"{plain_ms:.4f} ms/step -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K9 step {name} T={T} pos={pos} disagrees with its plain version")
    return err, ms, plain_ms


def check_k9_one_layer(name, t, tp, mesh, T, pos, cache_dtype, gen):
    """K9 on a one-layer shard of ``t`` (seeded) against the plain step on
    K9_ONE_LAYER_INPUTS seeded inputs: x within K1_SHALLOW_X_REL, every
    rank's written slot within K1_SHALLOW_SLOT_ABS, every other slot
    untouched, every rank's x the same bits, and K9_TIGHT_MIN inputs within
    K1_TIGHT_REL (x and slot).  Returns (max abs error, nan, nan)."""
    t1 = dataclasses.replace(t, num_layers=1)
    devices = mesh.model_devices()
    rows = tp_pack(t1, tp, mesh, gen)
    worst = slot_err = err = 0.0
    tight, untouched, ranks_equal, status = 0, True, True, []
    others = torch.ones(T, dtype=torch.bool, device=DEV)
    others[pos] = False
    for _ in range(K9_ONE_LAYER_INPUTS):
        x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
        kc, vc = tp_caches(t1, tp, T, pos, cache_dtype, gen, devices)
        kk, vk = [c.clone() for c in kc], [c.clone() for c in vc]
        kp, vp = [c.clone() for c in kc], [c.clone() for c in vc]
        run = K9.launch_step_tp(t1, rows, x, pos, kk, vk, mesh)
        xp, _, _ = K9.fused_decode_step_tp_reference(t1, rows, x, pos, kp, vp, mesh)
        torch.cuda.synchronize()
        status += statuses(run)
        ranks_equal &= all(torch.equal(v.to(DEV), run.x[0]) for v in run.xs)
        e = float((run.x - xp).abs().max())
        rel = e / float(xp.abs().max())
        s_err = max(float((a[:, :, :, pos].float() - b[:, :, :, pos].float()).abs().max())
                    for a, b in zip(kk + vk, kp + vp))
        s_rel = s_err / max(float(b[:, :, :, pos].float().abs().max()) for b in kp + vp)
        untouched &= all(bool(torch.equal(a[:, :, :, others], b[:, :, :, others]))
                         for a, b in zip(kk + vk, kc + vc))
        err, worst, slot_err = max(err, e), max(worst, rel), max(slot_err, s_err)
        tight += rel <= K1_TIGHT_REL and s_rel <= K1_TIGHT_REL
    ok = (worst < K1_SHALLOW_X_REL and slot_err < K1_SHALLOW_SLOT_ABS and untouched
          and ranks_equal and not any(status) and tight >= K9_TIGHT_MIN)
    log(f"K9 {name}-1-layer: tp={tp} T={T} pos={pos} cache={str(cache_dtype)[6:]} "
        f"{K9_ONE_LAYER_INPUTS} inputs: x max rel {worst:.3e} (tol {K1_SHALLOW_X_REL}) slot "
        f"max_abs_err={slot_err:.3e} (tol {K1_SHALLOW_SLOT_ABS}) tight (<= {K1_TIGHT_REL}) "
        f"{tight}/{K9_ONE_LAYER_INPUTS} (need {K9_TIGHT_MIN}) untouched_slots_equal={untouched} "
        f"every rank's x equal={ranks_equal} statuses set={sum(map(bool, status))} -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K9 {name} one layer T={T} pos={pos} disagrees with its plain version")
    return err, float("nan"), float("nan")


def k9_against_k1(label, t, k9_rows, mesh, k1_cfg, k1_fw, cases, gen):
    """K9 (``k9_rows`` on ``mesh``) against K1 (``k1_fw`` at ``k1_cfg``'s
    widths on rank 0's cache shard) on one seeded input per (T, pos) of
    ``cases`` and cache dtype: rank 0's x and cache shard equal bit for bit,
    every rank's x the same bits, no status set.  Returns the cases equal."""
    devices = mesh.model_devices()
    equal = total = 0
    for T, pos in cases:
        for cache_dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
            kc, vc = tp_caches(t, len(devices), T, pos, cache_dtype, gen, devices)
            k1k, k1v = kc[0].clone(), vc[0].clone()
            run = K9.launch_step_tp(t, k9_rows, x, pos, kc, vc, mesh)
            x1, _, _ = K1.fused_decode_step(k1_cfg, k1_fw, x, pos, k1k, k1v)
            torch.cuda.synchronize()
            good = (torch.equal(run.x, x1) and torch.equal(kc[0], k1k) and torch.equal(vc[0], k1v)
                    and all(torch.equal(v.to(DEV), run.x[0]) for v in run.xs)
                    and not any(statuses(run)))
            equal += good
            total += 1
            if not good:
                log(f"{label}: T={T} pos={pos} cache={str(cache_dtype)[6:]} x max_abs_err "
                    f"{float((run.x - x1).abs().max()):.3e}, statuses {statuses(run)} [{CARD}]")
    ok = equal == total
    log(f"{label}: {equal}/{total} steps equal K1 bit for bit (x and rank 0's cache shard) -> "
        f"{'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"{label}: K9 disagrees with K1")
    return equal


def check_k9_equals_k1(name, t, gen, cases=K9_EQUAL_CASES):
    """K9 at tp=1 (a mesh of this card once: the shard is the whole tensor)
    on the rows of JAX's pack against K1 on K1's own pack of the same raw
    weights: the packs equal leaf for leaf, then ``k9_against_k1``."""
    layers = init_transformer_params(t, gen, DEV)["layers"]
    mesh = make_mesh(1, 1, devices=card_devices(1))
    rows = K9.pack_rows(t, 1, K9.pack_fused_tp(t, layers, 1, mesh=mesh))
    k1 = K1.pack_fused_weights(t, layers)
    del layers
    same = all(torch.equal(a, b) for a, b in zip(rows.ranks[0], k1))
    log(f"K9 {name} tp=1: the row pack of JAX's units equals K1's pack of the same weights="
        f"{same} [{CARD}]")
    if not same:
        raise RuntimeError(f"K9 {name}: the tp=1 row pack is not K1's")
    return k9_against_k1(f"K9 {name} tp=1 against K1", t, rows, mesh, t, k1, cases, gen)


def check_k9_zero_peers(name, t, tp, rows, mesh, gen, cases=K9_EQUAL_CASES[:1]):
    """K9 on ``rows`` with every peer's rows and scales zero against K1 on
    rank 0's shard (a K1 weight set at the shard's widths, on rank 0's kv
    heads): rank 0's x = x + ((p0 + 0) + ...) = K1's x + p0, bit for bit."""
    zero = K9.FusedTPRows([rows.ranks[0]] + [
        w._replace(**{k: torch.zeros_like(getattr(w, k)) for k in ROW_LEAVES})
        for w in rows.ranks[1:]])
    return k9_against_k1(f"K9 {name} tp={tp}, every peer's rows zero, against K1 on rank 0's "
                         f"shard", t, zero, mesh, K9.shard_config(t, tp), rows.ranks[0], cases,
                         gen)


def check_k9_stalled(name, t, tp, rows, mesh, gen, T=256, pos=200):
    """K9 with every odd rank's sends held back K10_STALL_NS, two calls in a
    row on one seeded input, each equal to the unstalled step on it bit for
    bit (x and every cache shard), no status set: a wait that a stale flag
    satisfied would read the previous call's rows."""
    devices = mesh.model_devices()
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc, vc = tp_caches(t, tp, T, pos, torch.bfloat16, gen, devices)
    want_k, want_v = [c.clone() for c in kc], [c.clone() for c in vc]
    want = K9.launch_step_tp(t, rows, x, pos, want_k, want_v, mesh).x.clone()
    good = []
    for _ in range(2):
        kk, vk = [c.clone() for c in kc], [c.clone() for c in vc]
        run = K9.launch_step_tp(t, rows, x, pos, kk, vk, mesh, stall_ns=K10_STALL_NS)
        torch.cuda.synchronize()
        good.append(torch.equal(run.x, want) and not any(statuses(run)) and all(
            torch.equal(a, b) for a, b in zip(kk + vk, want_k + want_v)))
    ok = all(good)
    log(f"K9 {name} tp={tp}: two calls with odd ranks' sends stalled {K10_STALL_NS} ns equal the "
        f"unstalled step bit for bit={good} -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K9 {name}: a stalled exchange changed the step")


def check_k9_narrow_ring(name, t, tp, rows, mesh, gen, T=256, pos=200):
    """K9 on a one-slot ring and on a narrow one (``ring_variants``: four
    rows a stage, so each block's o rows span several stages, each copied
    only once the one before it is consumed) equal to the step on the
    default ring on the same input bit for bit (x and every cache shard).
    On the wider rings the o stage's copy lands during the attention phase,
    so a read of it before its wait goes unseen."""
    devices = mesh.model_devices()
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc, vc = tp_caches(t, tp, T, pos, torch.bfloat16, gen, devices)

    def step():
        kk, vk = [c.clone() for c in kc], [c.clone() for c in vc]
        return [K9.launch_step_tp(t, rows, x, pos, kk, vk, mesh).x.clone(), *kk, *vk]

    ring_variants(f"K9 {name} tp={tp} T={T} pos={pos}", step)


def check_k9_timeout(name, t, tp, rows, mesh, gen, T=256, pos=200):
    """A planted exchange timeout of K9: odd ranks hold each send back
    K10_TIMEOUT_STALL_NS against a wait limit of K10_TIMEOUT_NS, so the even
    ranks' status words are set, and ``check_timeouts`` on the tracked words
    (the engine path's read behind the launch) raises; then the entry's next
    call through ``fused_decode_step_tp`` equals a clean launch on the same
    input bit for bit and its words pass ``check_timeouts``."""
    devices = mesh.model_devices()
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc, vc = tp_caches(t, tp, T, pos, torch.bfloat16, gen, devices)
    run = K9.launch_step_tp(t, rows, x, pos, [c.clone() for c in kc], [c.clone() for c in vc],
                            mesh, stall_ns=K10_TIMEOUT_STALL_NS, timeout_ns=K10_TIMEOUT_NS)
    status = statuses(run)
    K9.track(run.status, "fused_decode_step_tp")
    try:
        K9.check_timeouts()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    xn, _, _ = K9.fused_decode_step_tp(t, rows, x, pos, [c.clone() for c in kc],
                                       [c.clone() for c in vc], mesh)
    K9.check_timeouts()  # the clean call's words
    xc = K9.launch_step_tp(t, rows, x, pos, [c.clone() for c in kc], [c.clone() for c in vc],
                           mesh).x
    clean = torch.equal(xn, xc)
    late = [r for r in range(tp) if status[r]]
    ok = late == list(range(0, tp, 2)) and "fused_decode_step_tp" in raised and clean
    log(f"K9 {name} tp={tp}: planted timeout (odd ranks' sends held {K10_TIMEOUT_STALL_NS} ns, "
        f"wait limit {K10_TIMEOUT_NS} ns): status={status}, raised={bool(raised)}; the next call "
        f"equals a clean launch={clean} -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"K9 {name}: a timed-out exchange was not reported, or the next call "
                           "was not clean")


def trace_k9(name, t, rows, mesh, gen, T=256, pos=200):
    """One traced K9 step (rank 0's blocks): per phase the slowest and mean
    block's work, the o and down phases' exchange inside their last part
    (from the last stage's dot products to the barrier's arrival), and the
    group barriers' latency."""
    devices = mesh.model_devices()
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc, vc = tp_caches(t, len(devices), T, pos, torch.bfloat16, gen, devices)
    plan = K9.step_entry(t, rows, T, devices).plans[0]
    trace_phases(f"K9 {name} tp={len(devices)} T={T} pos {pos} (rank 0; o and down: last "
                 f"refill + exchange)", plan, step_phase_names(t.num_layers),
                 lambda: K9.launch_step_tp(t, rows, x, pos, kc, vc, mesh))


def tp_chain_inputs(cp, gen, knobs):
    H, V, n = cp.transformer.hidden_size, cp.subcode_vocab_size, cp.num_steps
    sp = SamplingParams.create(*knobs)
    lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    noise = None if sp.greedy else gumbel_noise((n, 1, V), gen, DEV)
    return sp, lh, c0, noise


def check_k10(label, cp, tp, mesh, fw, heads, tables, fnorm, knobs, gen, calls=1, stall_ns=0,
              iters=0):
    """K10 against its plain version on ``calls`` seeded inputs in a row (the
    same entry: each call's flags carry a new generation).  The plain
    version rounds every product and sum as the kernel does and sums in its
    order, so every rank's sub-codes and final residual and rank 0's sub_sum
    must equal it bit for bit, and no exchange may time out.  Returns
    (sub_sum max abs error, ms per chain, plain ms)."""
    n, t = cp.num_steps, cp.transformer
    mode = "greedy" if knobs[0] <= 0 else f"sampled {knobs}"
    hs = K10._as_heads(heads, mesh.model_devices())
    ok, err, plain_ms = True, 0.0, float("nan")
    for call in range(calls):
        sp, lh, c0, noise = tp_chain_inputs(cp, gen, knobs)
        args = (fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p)
        run = K10.launch_chain_tp(t, tp, mesh, fw, *args, stall_ns=stall_ns)
        # the checked call (the plain version and its residual), timed
        (ps, psum, px), plain_call_ms = timed_call(lambda: K10.chain_tp_plain(
            t, tp, fw, fnorm, hs, tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p))
        if call == 0 and iters:
            plain_ms = plain_call_ms
        status = statuses(run)
        kern, plain = run.subcodes[0].tolist(), ps[0].tolist()
        diff = [j for j in range(n) if kern[j] != plain[j]]
        ranks_equal = all(torch.equal(c.to(DEV), ps[0].to(DEV)) for c in run.codes)
        x_equal = all(torch.equal(x.to(DEV), px) for x in run.x)
        x_err = max(float((x.to(DEV) - px).abs().max()) for x in run.x)
        e = float((run.sub_sum.to(DEV) - psum).abs().max())
        err = max(err, e)
        good = not diff and ranks_equal and x_equal and e == 0.0 and not any(status)
        ok &= good
        log(f"{label} {mode} call {call}{f' stall {stall_ns} ns' if stall_ns else ''}: kernel "
            f"{kern} plain {plain} equal={not diff}"
            + (f" (first mismatch at step {diff[0]})" if diff else "")
            + f"; every rank's codes equal the plain's={ranks_equal}, every rank's residual "
            f"equal the plain's={x_equal} (max_abs_err={x_err:.3e}), sub_sum "
            f"max_abs_err={e:.3e} (tol 0), status={status} -> {'ok' if good else 'FAIL'} "
            f"[{CARD}]")
    ms = float("nan")
    if iters:
        sp, lh, c0, noise = tp_chain_inputs(cp, gen, knobs)
        args = (fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p)
        ms = time_ms(lambda: K10.fused_mtp_chain_tp(t, tp, mesh, fw, *args), iters)
        log(f"{label} {mode}: {ms:.4f} ms/chain, plain {plain_ms:.4f} ms/chain [{CARD}]")
    if not ok:
        raise RuntimeError(f"{label} {mode} disagrees with its plain version")
    return err, ms, plain_ms


def check_k10_timeout(label, cp, tp, mesh, fw, heads, tables, fnorm, gen):
    """A planted exchange timeout: odd ranks hold each send back
    K10_TIMEOUT_STALL_NS against a wait limit of K10_TIMEOUT_NS, so the even
    ranks' status words are set, and ``check_timeouts`` on the tracked words
    (the engine path's read behind the launch) raises; then the entry's next
    call through ``fused_mtp_chain_tp`` (statuses zeroed) equals the plain
    version bit for bit and its words pass ``check_timeouts``."""
    t = cp.transformer
    sp, lh, c0, noise = tp_chain_inputs(cp, gen, K10_KNOBS[1])
    args = (fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p)
    run = K10.launch_chain_tp(t, tp, mesh, fw, *args, stall_ns=K10_TIMEOUT_STALL_NS,
                              timeout_ns=K10_TIMEOUT_NS)
    status = statuses(run)
    K10.track(run.status)
    try:
        K10.check_timeouts()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    subs, ssum = K10.fused_mtp_chain_tp(t, tp, mesh, fw, *args)
    K10.check_timeouts()  # the clean call's words
    ps, psum = K10.fused_mtp_chain_tp_reference(t, tp, fw, fnorm,
                                                K10._as_heads(heads, mesh.model_devices()),
                                                tables, lh, c0, noise, sp.temperature,
                                                sp.top_k, sp.top_p)
    clean = torch.equal(subs.to(DEV), ps.to(DEV)) and torch.equal(ssum.to(DEV), psum)
    late = [r for r in range(tp) if status[r]]
    ok = late == list(range(0, tp, 2)) and bool(raised) and clean
    log(f"{label}: planted timeout (odd ranks' sends held {K10_TIMEOUT_STALL_NS} ns, wait "
        f"limit {K10_TIMEOUT_NS} ns): status={status}, raised={bool(raised)}; the next call "
        f"equals the plain version={clean} -> {'ok' if ok else 'FAIL'} [{CARD}]")
    if not ok:
        raise RuntimeError(f"{label}: a timed-out exchange was not reported, or the next call "
                           "was not clean")


def tp_chain_packs(name, cfg, tp, mesh, gen):
    """The MTP trunk's per-rank row pack, its heads as int8 and as bf16 rank
    shards, tables and final norm, seeded."""
    cp = cfg.code_predictor
    H, V, n = cp.transformer.hidden_size, cp.subcode_vocab_size, cp.num_steps
    fw = tp_pack(cp.transformer, tp, mesh, gen)
    raw = (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)
    devices = mesh.model_devices()
    heads = {"int8": K10.shard_heads(quantize_weight(raw), devices),
             "bf16": K10.shard_heads(raw, devices)}
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    return cp, fw, heads, tables, fnorm


def chain_tp_bound(cp, tp, fw, heads):
    """Bound of one K10 chain: every rank's trunk shard and head rows read
    once (the ranks share the card's HBM), each step's table row, the outputs
    written; n + 1 trunk passes and n head products over all ranks."""
    t, n = cp.transformer, cp.num_steps
    H, V = t.hidden_size, cp.subcode_vocab_size
    moved = rows_bytes(fw) + nbytes(heads.q) + nbytes(heads.scale[:1]) + (
        n * H * 2 + H * 4 + n * 4)
    macs = rows_bytes(fw, ("wqkv", "wo", "wgu", "wd"))  # int8: 1 byte a multiply-add
    attn = t.num_layers * 4 * t.num_heads * t.head_dim * sum(range(1, n + 2))
    return bound(moved, 2 * ((n + 1) * macs + n * V * H) + attn)


def trace_k10(label, cp, tp, mesh, fw, heads, tables, fnorm, gen):
    """One traced K10 chain (rank 0's blocks, sampled): per phase the slowest
    and mean block's work, the o, down and head phases' exchange inside
    their last part, and the group barriers' latency."""
    sp, lh, c0, noise = tp_chain_inputs(cp, gen, K10_KNOBS[1])
    args = (fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p)
    e = K10.chain_entry(cp.transformer, tp, fw, K10._as_heads(heads, mesh.model_devices()),
                        tables, mesh.model_devices())
    trace_phases(f"{label} (rank 0; o, down and head: last refill + exchange)", e.plans[0],
                 chain_phase_names(cp.transformer.num_layers, cp.num_steps),
                 lambda: K10.launch_chain_tp(cp.transformer, tp, mesh, fw, *args))


def tp_kernel_checks(gen, card_line, devices_of=card_devices, first=True):
    """K9 and K10 against their plain versions (and K9 against K1) at the
    0.6B widths (tp=2) and the 1.7B widths (tp=4).  Returns (K9 checks,
    K10 checks, bounds)."""
    k9, k10, bounds = [], [], {}
    for name, cfg, tp in TP_MODELS:
        devices = devices_of(tp)
        mesh = make_mesh(1, tp, devices=devices)
        t = cfg.talker.transformer
        if first:  # four layers: the bit-for-bit checks hold layer by layer
            check_k9_equals_k1(f"{name} talker-4-layer", dataclasses.replace(t, num_layers=4),
                               gen)
        rows = tp_pack(t, tp, mesh, gen)
        if first:
            check_k9_zero_peers(f"{name} talker", t, tp, rows, mesh, gen)
        for T, pos in K9_CASES:
            k9.append(check_k9_step(f"{name} talker", t, tp, rows, mesh, T, pos, gen,
                                    10 if first and T == 256 else 0))
        if first:
            trace_k9(f"{name} talker", t, rows, mesh, gen)
        check_k9_stalled(f"{name} talker", t, tp, rows, mesh, gen)
        if first:
            check_k9_narrow_ring(f"{name} talker", t, tp, rows, mesh, gen)
        check_k9_timeout(f"{name} talker", t, tp, rows, mesh, gen)
        for cache_dtype in (torch.bfloat16, torch.float32):
            for T, pos in K9_CASES:
                k9.append(check_k9_one_layer(f"{name} talker", t, tp, mesh, T, pos, cache_dtype,
                                             gen))
        b = step_tp_bound(t, tp, rows, 200, torch.bfloat16)
        if name == "0.6B":
            bounds["K9"] = b
        log(f"K9 step bound {name} tp={tp} T=256 pos 200: {b[0]:.4f} ms ({b[1]}; "
            f"{rows_bytes(rows) / 1e6:.1f} MB of every rank's rows) [{CARD}]")
        del rows
        cp, fw, heads, tables, fnorm = tp_chain_packs(name, cfg, tp, mesh, gen)
        for kind in ("int8", "bf16"):
            for i, knobs in enumerate(K10_KNOBS):
                k10.append(check_k10(f"K10 {name} tp={tp} {kind} heads", cp, tp, mesh, fw,
                                     heads[kind], tables, fnorm, knobs, gen,
                                     iters=10 if first and i == 1 and kind == "int8" else 0))
        # every odd rank's sends held back: a wait that a stale flag satisfies
        # reads the previous call's values
        check_k10(f"K10 {name} tp={tp} bf16 heads", cp, tp, mesh, fw, heads["bf16"], tables,
                  fnorm, K10_KNOBS[1], gen, calls=2, stall_ns=K10_STALL_NS)
        rs = random_scales(fw, gen)
        check_k10(f"K10 {name} tp={tp} bf16 heads, row scales drawn anew", cp, tp, mesh, rs,
                  heads["bf16"], tables, fnorm, K10_KNOBS[0], gen)
        check_k10_timeout(f"K10 {name} tp={tp}", cp, tp, mesh, fw, heads["bf16"], tables, fnorm,
                          gen)
        if first:
            trace_k10(f"K10 {name} tp={tp} bf16 heads", cp, tp, mesh, fw, heads["bf16"], tables,
                      fnorm, gen)
        if name == "0.6B":
            bounds["K10"] = chain_tp_bound(cp, tp, fw, heads["bf16"])
        else:
            log(f"K10 bound {name} tp={tp}: {chain_tp_bound(cp, tp, fw, heads['bf16'])[0]:.4f} "
                f"ms [{CARD}]")
        del cp, fw, heads, tables, fnorm, rs
        torch.cuda.empty_cache()
    if first:
        tp_one_slot(gen)
    return k9, k10, bounds


def tp_one_slot(gen):
    """K9 and K10 again with every plan cut to one ring slot (a stage read
    without its mbarrier wait shows only there): K9 at tp=1 against K1 on a
    two-layer 0.6B talker, K9 at tp=2 on one layer against its plain
    version, K10 at the 0.6B widths against its plain version bit for bit."""
    name, cfg, tp = TP_MODELS[0]
    t = cfg.talker.transformer
    mesh = make_mesh(1, tp, devices=card_devices(tp))

    def checks():
        check_k9_equals_k1(f"{name} talker-2-layer, one ring slot",
                           dataclasses.replace(t, num_layers=2), gen, K9_EQUAL_CASES[:1])
        check_k9_one_layer(f"{name} talker, one ring slot", t, tp, mesh, 256, 200,
                           torch.bfloat16, gen)
        cp, fw, heads, tables, fnorm = tp_chain_packs(name, cfg, tp, mesh, gen)
        for kind, knobs in (("int8", K10_KNOBS[0]), ("bf16", K10_KNOBS[1])):
            check_k10(f"K10 {name} tp={tp} {kind} heads, one ring slot", cp, tp, mesh, fw,
                      heads[kind], tables, fnorm, knobs, gen)

    one_slot_ring(checks)


def tp_engine_runs(tok, card_line, devices_of=None):
    """``TTSEngine(config, params, mesh=make_mesh(1, tp, [card] * tp))`` with
    ``quantize`` unset: two 0.6B requests at tp=2, one 1.7B request at tp=4.
    One K9 and one K10 launch per decoded frame and device, no other
    kernel.  Returns the launch counts."""
    counts = [0] * len(KERNELS)
    for name, cfg, tp, reqs in (("0.6B", QWEN3_TTS_06B, 2, B1_REQUESTS[:2]),
                                ("1.7B", QWEN3_TTS_17B, 4, B1_REQUESTS[1:2])):
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
        devices = (devices_of or card_devices)(tp)
        eng = TTSEngine(config=cfg, params=params, tokenizer=tok,
                        mesh=make_mesh(1, tp, devices=devices))
        del params
        if not eng.is_ready():
            raise RuntimeError(f"{name} mesh engine not ready: {eng.get_error()}")
        torch.cuda.synchronize()
        log(f"{name} mesh engine tp={tp} on {[str(d) for d in devices]}, quantize unset, built "
            f"in {time.perf_counter() - t0:.1f} s [{card_line}]")
        reset_launches()
        decoded = 0
        for req in reqs:
            r = eng.synthesize(max_tokens=48, seed=SEED, **req)
            m = r.metrics
            decoded += m.decoded_frames
            if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                    r.audio).all() or r.codes.shape[1:] != (16,):
                raise RuntimeError(f"bad {name} mesh synthesis output for {req}")
            decode_ms = m.stage_seconds.get("decode", 0.0) * 1e3 / max(m.decoded_frames, 1)
            log(f"{name} mesh tp={tp} synthesize T={req['temperature']}: {m.frames} frames "
                f"({m.decoded_frames} decoded), {decode_ms:.3f} ms/frame decode, RTF "
                f"{m.rtf:.2f}x, TTFA {m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
        n_dev = len(set(devices))
        got = check_launches(f"{name} mesh tp={tp} (one K9 and one K10 per frame and device)",
                             counts_of(K9=decoded * n_dev, K10=decoded * n_dev))
        counts = [a + b for a, b in zip(counts, got)]
        del eng
        torch.cuda.empty_cache()
    return counts


MESH_KERNEL_FRAMES = 8  # the meshes whose B=1 routes mix a kernel and a plain route


def mesh_route_runs(tok, card_line):
    """Phase 14 (c): B=1 requests on the meshes whose routes mix a kernel
    with a plain route, as JAX's gates route them, each's launch counts
    derived from those routes and checked, and its seconds logged.
    Returns the launch counts."""
    counts = [0] * len(KERNELS)
    req = dict(text=FIXED_TEXT, language="en", temperature=0.0,
               max_tokens=MESH_KERNEL_FRAMES)
    params = init_params(QWEN3_TTS_06B, seed=SEED, device=DEV, with_speaker_encoder=False)

    def run(label, eng, want_of, packs):
        nonlocal counts
        t0 = time.perf_counter()
        if not eng.is_ready():
            raise RuntimeError(f"{label}: engine not ready: {eng.get_error()}")
        got = tuple("fused_tp" in eng.params[k] for k in ("talker", "code_predictor"))
        if got != packs:
            raise RuntimeError(f"{label}: K9 / K10 packs {got}, JAX's routes give {packs}")
        reset_launches()
        r = eng.synthesize(**req)
        m = r.metrics
        if (r.codes.shape[1:] != (16,) or not np.isfinite(r.audio).all()
                or r.audio.shape != (len(r.codes) * SAMPLES_PER_FRAME,)):
            raise RuntimeError(f"{label}: bad output")
        n_dev = len(set(eng.mesh.model_devices()))
        ms = m.stage_seconds["decode"] * 1e3 / max(m.decoded_frames, 1)
        want, why = want_of(m, n_dev)
        log(f"{label}: {m.frames} frames ({m.decoded_frames} decoded), {ms:.3f} ms/frame "
            f"decode, {time.perf_counter() - t0:.1f} s [{card_line}]")
        counts = [a + b for a, b in zip(counts, check_launches(f"{label} ({why})", want))]

    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, mesh=card_mesh(1, 2),
                    kv_quant=True)
    run("0.6B mesh tp=2 kv_quant B=1", eng,
        lambda m, d: (counts_of(K10=m.decoded_frames * d), "the plain step on the int8 cache, "
                      "one K10 per frame and device"), (False, True))
    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, mesh=card_mesh(2, 2))
    run("0.6B make_mesh(2, 2) B=1", eng,
        lambda m, d: (counts_of(K9=m.decoded_frames * d, K10=m.decoded_frames * d),
                      "one K9 and one K10 per frame on the first data row's ranks"),
        (True, True))
    # the acceptance floor trips after one iteration: the sequential steps
    # after the conversion are K9's and the chains K10's
    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, mesh=card_mesh(1, 2),
                    spec_k=SPEC_K, spec_iters=1, spec_accept_floor=1.1, spec_adapt_window=1)

    def spec_counts(m, d):
        seq = m.decoded_frames - 1 - m.spec_iterations * SPEC_K if m.spec_fallback else 0
        return (counts_of(K9=seq * d, K10=seq * d),
                f"{m.spec_iterations} verify iteration(s) on the plain layers with cached "
                f"chains, fallback {m.spec_fallback}, then one K9 and one K10 per sequential "
                f"frame: {seq}")

    run(f"0.6B mesh tp=2 spec_k={SPEC_K} B=1", eng, spec_counts, (True, True))
    del eng, params
    torch.cuda.empty_cache()
    params = init_params(QWEN3_TTS_17B, seed=SEED, device=DEV, with_speaker_encoder=False)
    eng = TTSEngine(config=QWEN3_TTS_17B, params=params, tokenizer=tok, mesh=card_mesh(1, 2))
    del params
    run("1.7B mesh tp=2 B=1", eng,
        lambda m, d: (counts_of(K9=m.decoded_frames * d), "one K9 per frame and device "
                      "beside the cached chain"), (True, False))
    del eng
    torch.cuda.empty_cache()
    return counts


def tp_phase(tok, gen, card_line):
    """Phase 14: the tensor-parallel decode path.  Returns (launch counts,
    (K9, K10 checks), bounds)."""
    t0 = time.perf_counter()
    k9, k10, bounds = tp_kernel_checks(gen, card_line)
    counts = [a + b for a, b in zip(tp_engine_runs(tok, card_line),
                                    mesh_route_runs(tok, card_line))]
    if torch.cuda.device_count() >= 2:
        # the same kernels with the ranks on distinct cards (peer pointers,
        # the exchange at system scope)
        cards = torch.cuda.device_count()

        def spread(tp):  # consecutive ranks share a card
            return [torch.device("cuda", r * min(cards, tp) // tp) for r in range(tp)]

        tp_kernel_checks(gen, card_line, devices_of=spread, first=False)
        tp_engine_runs(tok, card_line, devices_of=spread)
    else:
        log(f"tensor-parallel path across distinct cards: not run, this machine has "
            f"{torch.cuda.device_count()} card [{card_line}]")
    log(f"tensor-parallel phase: {time.perf_counter() - t0:.1f} s [{card_line}]")
    return counts, (k9, k10), bounds

# ---------------------------------------------------------------------------
# Phase 15: every weight precision (int4 units in K1-K6; chain heads of
# another type than the trunk in K2, K3 and K5; bf16 units in K6)
# ---------------------------------------------------------------------------

# K3 == K2 on a float32 cache at int4 trunks and mixed heads: seeded chains
PRECISION_K3_EQUAL_INPUTS = 4
PRECISION_CLI_FRAMES = 24


def ring_variants(label, run):
    """``run()`` (its outputs, tensors) on the default ring, on a one-slot
    ring and on a narrow one (four rows a stage: every stage's copy issued
    only once the stage before it is consumed): every output equal bit for
    bit.  A kernel's values do not depend on its plan (each row's dot
    product keeps its order whatever stage holds it), and a stage read
    before its wait shows only where its copy is still in flight."""
    want = [x.clone() for x in run()]
    got = {"one ring slot": one_slot_ring(run),
           "one narrow slot": one_slot_ring(run, narrow=True)}
    same = {k: all(bool(torch.equal(a, b)) for a, b in zip(v, want)) for k, v in got.items()}
    ok = all(same.values())
    log(f"{label}: equal bit for bit to the default ring {same} -> {'ok' if ok else 'FAIL'} "
        f"[{CARD}]")
    if not ok:
        raise RuntimeError(f"{label}: a ring variant changed the kernel's values")


def raw_layers(t, gen):
    """A random transformer's fused raw layers on the card."""
    return fuse_params({"m": {"transformer": init_transformer_params(t, gen, DEV)}},
                       modules=("m",))["m"]["transformer"]["layers"]


def int4_trunk(t, gen):
    """A real int4 pack of ``t`` (bits=4 from raw weights, the engine's)."""
    return K1.pack_fused_weights(t, raw_layers(t, gen), bits=4)


def precision_k1(name, t, fw4, gen, deep_cases, shallow_cases, iters):
    """K1 at int4 units: ``deep_cases`` (T, pos) at full depth on a bf16
    cache and one on an int8 cache (deep limits), ``shallow_cases`` on one
    layer on float32, bf16 and int8 caches (one-layer limits, tight counts).
    Returns the checks (first timed) and the int8-cache check."""
    checks = [check_k1_deep(f"{name} int4", t, fw4, T, pos, gen, iters if i == 0 else 5)
              for i, (T, pos) in enumerate(deep_cases)]
    T, pos = deep_cases[0]
    kvq = check_kvq_k1(f"{name} int4", t, fw4, T, pos, gen, 1, iters)
    ts = dataclasses.replace(t, num_layers=K1_SHALLOW_LAYERS)
    fws = int4_trunk(ts, gen)
    for T, pos in shallow_cases:
        for cache_dtype in (torch.float32, torch.bfloat16):
            checks.append(check_k1_shallow(f"{name}-{K1_SHALLOW_LAYERS}-layer int4", ts, fws, T,
                                           pos, cache_dtype, gen, 0))
        check_kvq_k1(f"{name}-{K1_SHALLOW_LAYERS}-layer int4", ts, fws, T, pos, gen,
                     K1_TIGHT_INPUTS, 0)
    return checks, kvq


def precision_kernel_checks(gen, card_line):
    """K1 int4 against its plain version at 0.6B and 1.7B; K2 and K3 on int4
    trunks and with heads of another type than the trunk against their plain
    versions, K3 == K2 on a float32 cache; K6 at bf16 units against its
    plain version, its rows the K1 bf16 steps bit for bit, on bf16 and int8
    caches; each new instance on a one-slot ring and on a narrow one.
    Returns (checks by report key, bounds)."""
    checks, bounds = {}, {}
    cfg = QWEN3_TTS_06B
    talker_t, cp = cfg.talker.transformer, cfg.code_predictor
    mtp_t = cp.transformer
    fw4 = int4_trunk(talker_t, gen)
    checks["K1 int4"], checks["K1 int4 kvq"] = precision_k1(
        "talker", talker_t, fw4, gen, ((256, 200), (2560, 1800)), ((256, 63), (2560, 2559)), 20)
    bounds["K1 int4"] = step_bound(talker_t, fw4, 1, [200], 1, torch.bfloat16)
    int8_fw = packed_trunk(talker_t, gen)
    log(f"K1 0.6B talker bytes per step: int4 {nbytes(fw4) / 1e6:.1f} MB (rows "
        f"{nbytes([fw4.wqkv, fw4.wo, fw4.wgu, fw4.wd]) / 1e6:.1f} MB), int8 "
        f"{nbytes(int8_fw) / 1e6:.1f} MB; bound {bounds['K1 int4'][0]:.4f} ms against "
        f"{step_bound(talker_t, int8_fw, 1, [200], 1, torch.bfloat16)[0]:.4f} [{CARD}]")
    x, kc, vc = k1_inputs(talker_t, 256, 200, torch.bfloat16, gen)
    in_turns("K1 0.6B talker T=256 pos 200, int8 / int4 units",
             lambda: K1.fused_decode_step(talker_t, int8_fw, x, 200, kc, vc),
             lambda: K1.fused_decode_step(talker_t, fw4, x, 200, kc, vc), 20,
             names=("int8 units", "int4 units"))
    trace_phases("K1 int4 0.6B talker T=256 pos 200",
                 K1._step_entry(talker_t, fw4, 256, x.device).plan,
                 step_phase_names(talker_t.num_layers),
                 lambda: K1.fused_decode_step(talker_t, fw4, x, 200, kc, vc))
    del int8_fw, x, kc, vc
    t2 = dataclasses.replace(talker_t, num_layers=2)
    fw2 = int4_trunk(t2, gen)
    for cache_dtype in (torch.bfloat16, torch.int8):
        if cache_dtype == torch.int8:
            x = torch.randn((1, t2.hidden_size), generator=gen, device=DEV) * 0.3
            base = q8_cache(t2, 1, 256, [200], gen)
        else:
            x, kc, vc = k1_inputs(t2, 256, 200, cache_dtype, gen)
            base = [kc, vc]

        def k1_once(x=x, base=base):
            c = clone_all(base)
            return (K1.fused_decode_step(t2, fw2, x, 200, *c)[0], *c)

        ring_variants(f"K1 int4 talker-2-layer, {str(cache_dtype)[6:]} cache", k1_once)
    del fw4, fw2

    # the chains: int4 trunks with int8 heads (--quantize int4), int8 and
    # int4 trunks with bf16 heads (an unset --quantize beside --mtp-quantize)
    H, V, n = mtp_t.hidden_size, cp.subcode_vocab_size, cp.num_steps
    m_raw = raw_layers(mtp_t, gen)
    m4 = K1.pack_fused_weights(mtp_t, m_raw, bits=4)
    m8 = K1.pack_fused_weights(mtp_t, m_raw, bits=8)
    del m_raw
    raw_heads = (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)
    h8, h16 = K2.pack_heads(quantize_weight(raw_heads)), K2.pack_heads(raw_heads)
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    for key, fw, heads in (("K2 int4", m4, h8), ("K2 int8 trunk, bf16 heads", m8, h16),
                           ("K2 int4 trunk, bf16 heads", m4, h16)):
        if not K2.supports_resident(fw):
            raise RuntimeError(f"{key}: the 0.6B trunk fails K2's residency gate")
        # K5's flip rule: on the bf16 cache a rounding flip moves the 6-layer
        # trunk's x by up to ~4e-3 relative, so a near-tie sub-code may flip
        # (a greedy step at a 9.2e-4 score margin of one seeded int4 chain on
        # an H100); a fault in the units picks unrelated tokens
        checks[key] = [check_chain(key, K2.fused_mtp_chain, K2.fused_mtp_chain_reference, knobs,
                                   cp, fw, heads, tables, fnorm, gen, iters, flip_rule=True,
                                   cache_dtype=torch.bfloat16)
                       for knobs, iters in (((0.8, 50, 0.95), 10), ((0.0,), 0))]
        bounds[key] = chain_bound(mtp_t, fw, heads, 1)
        check_k3_equals_k2(cp, fw, heads, tables, fnorm, gen, 0,
                           inputs=PRECISION_K3_EQUAL_INPUTS)
        lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        noise = gumbel_noise((n, 1, V), gen, DEV)

        def chain_once(fw=fw, heads=heads, lh=lh, c0=c0, noise=noise):
            return K2.fused_mtp_chain(mtp_t, fw, fnorm, heads, tables, lh, c0, noise,
                                      *K5_KNOBS[1], cache_dtype=torch.bfloat16)

        ring_variants(f"{key} 0.6B sampled", chain_once)
        if key == "K2 int4":
            ring_variants("K3 int4 0.6B sampled", lambda: K3.fused_mtp_chain_streamed(
                mtp_t, m4, fnorm, h8, tables, lh, c0, noise, *K5_KNOBS[1]))
            trace_phases("K2 int4 0.6B sampled",
                         K2._chain_entry("qtts_mtp_chain", mtp_t, fw, heads, tables,
                                         torch.bfloat16, lh.device).plan,
                         chain_phase_names(mtp_t.num_layers, n), chain_once)
    del m4, m8, h8, h16, raw_heads, tables

    # K6 at bf16 units (--spec-k at an unset --quantize), 0.6B
    fwb = bf16_trunk(talker_t, gen)
    checks["K6 bf16"] = [check_k6_deep("talker bf16", talker_t, fwb, B, S, T, starts, gen, iters)
                         for B, S, T, starts, iters in K6_DEEP_CASES[:2] + K6_DEEP_CASES[3:]]
    bounds["K6 bf16"] = checks["K6 bf16"][0][3]
    checks["K6 bf16 kvq"] = check_kvq_k6("talker bf16", talker_t, fwb, 1, 4, 256, [200], gen,
                                         10)
    tsb = dataclasses.replace(talker_t, num_layers=K1_SHALLOW_LAYERS)
    fwsb = bf16_trunk(tsb, gen)
    for cache_dtype in (torch.float32, torch.bfloat16):
        for B, S, starts in K6_SHALLOW_CASES[1:2] + K6_SHALLOW_CASES[4:]:
            check_k6_shallow(tsb, fwsb, B, S, 512, starts, cache_dtype, gen)
    check_kvq_k6(f"talker-{K1_SHALLOW_LAYERS}-layer bf16", tsb, fwsb, 4, 8, 512,
                 [62, 5, 504, 130], gen, 0, stall_ns=K6_STALL_NS)
    for cache_dtype in (torch.bfloat16, torch.int8):
        x, _, _, pos_dev = k6_inputs(tsb, 4, 8, 512, [62, 5, 504, 130], torch.bfloat16, gen)
        base = (q8_cache(tsb, 4, 512, [62, 5, 504, 130], gen) if cache_dtype == torch.int8
                else list(k6_inputs(tsb, 4, 8, 512, [62, 5, 504, 130], cache_dtype, gen)[1:3]))

        def k6_once(x=x, base=base, pos_dev=pos_dev):
            c = clone_all(base)
            return (K6.fused_verify_step(tsb, fwsb, x, pos_dev, *c)[0], *c)

        ring_variants(f"K6 bf16 talker-1-layer 4 x 8, {str(cache_dtype)[6:]} cache", k6_once)
    x, kc, vc, starts = k6_inputs(talker_t, 1, 4, 256, [200], torch.bfloat16, gen)
    trace_phases("K6 bf16 0.6B talker B=1 S=4 T=256 start 200",
                 K6._verify_entry(talker_t, fwb, 1, 4, 256, torch.bfloat16, x.device).plan,
                 verify_phase_names(talker_t.num_layers),
                 lambda: K6.fused_verify_step(talker_t, fwb, x, starts, kc, vc))
    del fwb, fwsb, x, kc, vc
    torch.cuda.empty_cache()

    # 1.7B: K1 int4 at H=2048, K3 on the int4 trunk (int8 heads) and on an
    # int8 trunk with bf16 heads
    c17 = QWEN3_TTS_17B
    t17, cp17 = c17.talker.transformer, c17.code_predictor
    fw17 = int4_trunk(t17, gen)
    k1_17, _ = precision_k1("talker-1.7B", t17, fw17, gen, ((256, 60),), ((1024, 1023),), 10)
    checks["K1 int4"] += k1_17
    log(f"K1 int4 talker-1.7B bound {step_bound(t17, fw17, 1, [60], 1, torch.bfloat16)[0]:.4f} ms "
        f"({nbytes(fw17) / 1e9:.3f} GB per step) [{CARD}]")
    del fw17
    m17 = cp17.transformer
    H, V, n = m17.hidden_size, cp17.subcode_vocab_size, cp17.num_steps
    m_raw = raw_layers(m17, gen)
    m4 = K1.pack_fused_weights(m17, m_raw, bits=4)
    m8 = K1.pack_fused_weights(m17, m_raw, bits=8)
    del m_raw
    raw_heads = (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)
    h8, h16 = K2.pack_heads(quantize_weight(raw_heads)), K2.pack_heads(raw_heads)
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    for key, fw, heads in (("K3 int4", m4, h8), ("K3 int8 trunk, bf16 heads", m8, h16)):
        if K2.supports_resident(fw) or not K3.supports_stream(fw, V):
            raise RuntimeError(f"{key}: the 1.7B trunk must route to K3")
        checks[key] = [check_chain(f"{key} 1.7B", K3.fused_mtp_chain_streamed,
                                   K3.fused_mtp_chain_streamed_reference, knobs, cp17, fw, heads,
                                   tables, fnorm, gen, iters, flip_rule=True)
                       for knobs, iters in (((0.8, 50, 0.95), 5), ((0.0,), 0))]
        bounds[key] = chain_bound(m17, fw, heads, 1)
        check_k3_equals_k2(cp17, fw, heads, tables, fnorm, gen, 0, inputs=2)
    del m4, m8, h8, h16, raw_heads, tables
    torch.cuda.empty_cache()
    return checks, bounds


def precision_batched_checks(gen):
    """The batched kernels at the precision flags' units, 0.6B: K4 and K6 at
    int4 units against their plain versions (deep and one-layer limits), K4
    rows equal the K1 int4 steps and K6 rows the K1 / K4 int4 steps bit for
    bit, also on an int8 cache; K5 on an int4 trunk with int8 heads, and on
    int8 and int4 trunks with bf16 heads (the mixed heads, and the auto alt
    trunk of an unquantized talker) against its plain version at B=8 (K5's
    flip rule), its rows equal K2's on the same pack bit for bit at 2, 8 and
    32 rows; each on a one-slot ring and a narrow one.  Returns (checks by
    report key, bounds)."""
    checks, bounds = {}, {}
    cfg = QWEN3_TTS_06B
    talker_t, cp = cfg.talker.transformer, cfg.code_predictor
    mtp_t = cp.transformer
    fw4 = int4_trunk(talker_t, gen)
    checks["K4 int4"] = [check_k4_deep("talker int4", talker_t, fw4, 8, 512, gen, 10),
                         check_k4_deep("talker int4", talker_t, fw4, 32, 512, gen, 3)]
    bounds["K4 int4"] = step_bound(talker_t, fw4, 8, [min(p, 511) for p in K4_POSITIONS], 1,
                                   torch.bfloat16)
    check_kvq_k4("talker int4", talker_t, fw4, 8, 512, gen, 0)
    checks["K6 int4"] = [check_k6_deep("talker int4", talker_t, fw4, B, S, T, starts, gen, iters)
                         for B, S, T, starts, iters in K6_DEEP_CASES[:1] + K6_DEEP_CASES[3:]]
    bounds["K6 int4"] = checks["K6 int4"][0][3]
    checks["K6 int4 kvq"] = check_kvq_k6("talker int4", talker_t, fw4, 1, 4, 256, [200], gen, 10)
    x, kc, vc, starts = k6_inputs(talker_t, 1, 4, 256, [200], torch.bfloat16, gen)
    trace_phases("K6 int4 0.6B talker B=1 S=4 T=256 start 200",
                 K6._verify_entry(talker_t, fw4, 1, 4, 256, torch.bfloat16, x.device).plan,
                 verify_phase_names(talker_t.num_layers),
                 lambda: K6.fused_verify_step(talker_t, fw4, x, starts, kc, vc))
    del fw4, x, kc, vc
    tsi = dataclasses.replace(talker_t, num_layers=K1_SHALLOW_LAYERS)
    fws = int4_trunk(tsi, gen)
    for cache_dtype in (torch.float32, torch.bfloat16):
        checks["K4 int4"][0] = (max(checks["K4 int4"][0][0], check_k4_shallow(
            tsi, fws, 8, 512, cache_dtype, gen)),) + checks["K4 int4"][0][1:]
        check_k6_shallow(tsi, fws, 4, 4, 512, [0, 61, 200, 600], cache_dtype, gen)
    del fws
    t2 = dataclasses.replace(talker_t, num_layers=2)
    fw2 = int4_trunk(t2, gen)
    for cache_dtype in (torch.bfloat16, torch.int8):
        x4, _, _, pos = k4_inputs(t2, 8, 512, torch.bfloat16, gen)
        x6, _, _, starts = k6_inputs(t2, 4, 4, 512, [62, 5, 504, 130], torch.bfloat16, gen)
        if cache_dtype == torch.int8:
            base4 = q8_cache(t2, 8, 512, pos, gen)
            base6 = q8_cache(t2, 4, 512, [62, 5, 504, 130], gen)
        else:
            base4 = list(k4_inputs(t2, 8, 512, cache_dtype, gen)[1:3])
            base6 = list(k6_inputs(t2, 4, 4, 512, [62, 5, 504, 130], cache_dtype, gen)[1:3])
        pos_dev = torch.tensor(pos, device=DEV)

        def k4_once(x=x4, base=base4, pos_dev=pos_dev):
            c = clone_all(base)
            return (K1.fused_decode_step_batched(t2, fw2, x, pos_dev, *c)[0], *c)

        def k6_once(x=x6, base=base6, starts=starts):
            c = clone_all(base)
            return (K6.fused_verify_step(t2, fw2, x, starts, *c)[0], *c)

        ring_variants(f"K4 int4 talker-2-layer B=8, {str(cache_dtype)[6:]} cache", k4_once)
        ring_variants(f"K6 int4 talker-2-layer 4 x 4, {str(cache_dtype)[6:]} cache", k6_once)
    del fw2

    H, V, n = mtp_t.hidden_size, cp.subcode_vocab_size, cp.num_steps
    m_raw = raw_layers(mtp_t, gen)
    m4 = K1.pack_fused_weights(mtp_t, m_raw, bits=4)
    m8 = K1.pack_fused_weights(mtp_t, m_raw, bits=8)
    del m_raw
    raw_heads = (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)
    h8, h16 = K2.pack_heads(quantize_weight(raw_heads)), K2.pack_heads(raw_heads)
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    for key, fw, heads in (("K5 int4", m4, h8), ("K5 int8 trunk, bf16 heads", m8, h16),
                           ("K5 int4 trunk, bf16 heads", m4, h16)):
        # B=32 rows against K2 in check_k5_equal: its plain chain takes ~13 s
        checks[key] = [check_k5(8, cp, fw, heads, tables, fnorm, gen, 5)]
        bounds[key] = chain_bound(mtp_t, fw, heads, 8)
        check_k5_equal(f"0.6B MTP trunk {key[3:]}", cp, fw, heads, tables, fnorm, gen,
                       batches=(2, 32), cache_dtypes=(torch.bfloat16, torch.float32), multi=False)
        lh = (torch.randn((8, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((8, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        noise = gumbel_noise((n, 8, V), gen, DEV)
        knobs = list(zip(*[K5_KNOBS[b % len(K5_KNOBS)] for b in range(8)]))

        def chain_once(fw=fw, heads=heads, lh=lh, c0=c0, noise=noise, knobs=knobs):
            return K2.fused_mtp_chain_batched(mtp_t, fw, fnorm, heads, tables, lh, c0, noise,
                                              *knobs, cache_dtype=torch.bfloat16)

        ring_variants(f"{key} 0.6B B=8 mixed knobs", chain_once)
        if key == "K5 int4":
            trace_phases("K5 int4 0.6B B=8 mixed knobs",
                         K2._batch_chain_entry("qtts_mtp_chain_batched", mtp_t, fw, heads,
                                               tables, 8, torch.bfloat16, lh.device).plan,
                         chain_phase_names(mtp_t.num_layers, n, batched=True), chain_once)
    del m4, m8, h8, h16, raw_heads, tables
    torch.cuda.empty_cache()
    return checks, bounds


BATCHED_RUN_TEXTS = ["hello world", "hello", "a quick test of the batch", "world"]


def with_prefills(eng, want):
    """``want`` with K8's count as launched where the talker's prefill
    attention is K8 (the 1.7B preset: a positive multiple of its layers,
    one per layer and prefill call), else none."""
    t = eng.cfg.talker.transformer
    k8 = KERNEL_IDS.index("K8")
    got = launches()[k8] if t.attn_impl == "pallas" else 0
    if t.attn_impl == "pallas" and (got == 0 or got % t.num_layers):
        raise RuntimeError(f"{got} K8 launches: not a multiple of the {t.num_layers} layers")
    return want[:k8] + (got,) + want[k8 + 1:]


def batched_runs(eng, label, card_line, pool=True):
    """``synthesize_batch`` of four texts (one K4 and one K5 per batched
    frame) and, with ``pool``, eight requests through an 8-slot pool (one K4
    and one K5 per pooled frame) and a greedy pool request against
    ``synthesize`` at B=1 (codes equal: each pool row is the B=1 kernels'
    row bit for bit).  Returns the launch counts."""
    reset_launches()
    t0 = time.perf_counter()
    results = eng.synthesize_batch(BATCHED_RUN_TEXTS, language="en", temperature=0.8, top_k=50,
                                   top_p=0.95, max_tokens=24, seed=list(range(4)))
    wall = time.perf_counter() - t0
    decoded = results[0].metrics.decoded_frames
    for r in results:
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"{label}: bad synthesize_batch output")
    counts = [check_launches(f"{label} synthesize_batch B=4 ({decoded} batched frames)",
                             with_prefills(eng, counts_of(K4=decoded, K5=decoded)))]
    log(f"{label} synthesize_batch B=4: frames {[r.metrics.frames for r in results]}, "
        f"{results[0].metrics.stage_seconds['decode'] * 1e3 / decoded:.3f} ms per batched frame, "
        f"{wall:.2f} s of wall time [{card_line}]")
    if pool:
        p = ContinuousBatcher(eng, pool_size=8, chunk_len=16, kv_bucket=eng.kv_ladder[0])
        try:
            reset_launches()
            t0 = time.perf_counter()
            futs = [p.submit(text, language=lang, temperature=k[0], top_k=k[1], top_p=k[2],
                             max_tokens=min(mt, 16), seed=SEED + i)
                    for i, (text, lang, k, mt) in enumerate(POOL_REQUESTS[:8])]
            pooled = [f.result(timeout=600) for f in futs]
            text = "hello world, greedy through the pool"
            got = p.synthesize(text, language="en", temperature=0.0, max_tokens=16)
            wall = time.perf_counter() - t0
            chunks = p.stats["chunks"]
            for r in pooled + [got]:
                if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                        r.audio).all():
                    raise RuntimeError(f"{label} pool: bad result")
            counts.append(check_launches(f"{label} pool of 8 ({chunks} chunks of 16 frames)",
                                         with_prefills(eng, counts_of(K4=16 * chunks,
                                                                      K5=16 * chunks))))
        finally:
            p.shutdown()
        want = eng.synthesize(text, language="en", temperature=0.0, max_tokens=16)
        equal = np.array_equal(got.codes, want.codes)
        log(f"{label} pool: 9 requests through 8 slots in {wall:.2f} s, {chunks} chunks; greedy "
            f"pool request vs synthesize at B=1: {len(got.codes)} frames, codes equal={equal} "
            f"[{card_line}]")
        if not equal:
            raise RuntimeError(f"{label}: greedy pool output differs from synthesize at B=1")
    return [sum(c) for c in zip(*counts)]


def precision_engines(tok, card_line):
    """The batched paths of the precision flags at the 0.6B preset, one
    engine each from the same weights: ``quantize="int4"`` (K4 int4, K5 on
    the int4 trunk with int8 heads), ``mtp_quantize="int8"`` and ``"auto"``
    beside an unset ``quantize`` (K4 bf16; K5 on the int8 trunk and on the
    int4 alt trunk with bf16 heads), and ``quantize="int8",
    mtp_quantize="auto"`` at B=32, where JAX's ``resident_pack`` takes the
    int4 alt trunk (K5 on it with int8 heads).  Returns launch counts by
    report key."""
    cfg = QWEN3_TTS_06B
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    counts = {}
    cpk = K2.fused_mtp_chain_batched
    for key, kw, unit, rows in (
            ("K5 int4", dict(quantize="int4"), torch.uint8, 8),
            ("K5 int8 trunk, bf16 heads", dict(mtp_quantize="int8"), torch.int8, 8),
            ("K5 int4 trunk, bf16 heads", dict(mtp_quantize="auto"), torch.uint8, 8),
            ("K5 int4 alt trunk, int8 heads", dict(quantize="int8", mtp_quantize="auto"),
             torch.uint8, 32)):
        t0 = time.perf_counter()
        eng = TTSEngine(config=cfg, params=params, tokenizer=tok, **kw)
        if not eng.is_ready():
            raise RuntimeError(f"0.6B engine at {kw}: {eng.get_error()}")
        cpp = eng.params["code_predictor"]
        if chain_pack(cpp, cpk, rows).wqkv.dtype != unit:
            raise RuntimeError(f"the 0.6B engine at {kw} does not take {unit} trunks in K5 at "
                               f"{rows} rows")
        log(f"engine: 0.6B preset at {kw}, built in {time.perf_counter() - t0:.1f} s; K5's pack "
            f"at {rows} rows: {str(unit)[6:]} units [{card_line}]")
        if rows == 32:
            reset_launches()
            texts = [BATCH_TEXTS[b % len(BATCH_TEXTS)] for b in range(32)]
            results = eng.synthesize_batch(texts, language="en", temperature=0.8, max_tokens=16,
                                           seed=list(range(32)))
            d = results[0].metrics.decoded_frames
            if any(not np.isfinite(r.audio).all() or r.codes.shape[1:] != (16,)
                   for r in results):
                raise RuntimeError(f"0.6B {kw} synthesize_batch B=32: bad output")
            counts[key] = check_launches(
                f"0.6B {kw} synthesize_batch B=32 (K5 on the int4 alt trunk)",
                counts_of(K4=d, K5=d))
        else:
            counts[key] = batched_runs(eng, f"0.6B {kw}", card_line)
        if key == "K5 int4":  # past 32 rows: K4 and K5 int4 in two launches of 24 rows
            counts[key] = [a + b for a, b in zip(counts[key], batch_rows_equal(
                eng, 48, f"0.6B {kw}", card_line))]
            counts["K4 int4"] = counts[key]
        del eng
        torch.cuda.empty_cache()
    del params
    return counts


def precision_cli(tok, card_line):
    """The CLI at the 0.6B preset from a checkpoint, in process, under the
    flags this phase adds: --quantize int4 (one K1 int4 and one K2 int4 per
    frame), --quantize int4 --kv-quant, --mtp-quantize int8 and
    --mtp-quantize auto at an unset --quantize (K1 bf16 and K2 on the int8
    trunk or the int4 alt trunk, bf16 heads), --spec-k 4 at an unset
    --quantize (K6 and K5 at bf16 units), also with --kv-quant, --spec-k 4
    with --quantize int4 --kv-quant (K6 int4 on an int8 cache, K5 int4) and
    with --mtp-quantize int8 (K5 on the int8 trunk with bf16 heads),
    --frame-fused on at --quantize int4 and beside --mtp-quantize int8 (one
    K7 per decoded frame: int4 units; a bf16 talker with bf16 heads beside
    the int8 trunk).  (The server at --quantize int4 boots in the entry
    phase, beside the others.)
    Returns ({flags: launch counts}, {flags: ms per frame})."""
    cfg = QWEN3_TTS_06B
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    counts, ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "qwen3-tts-0.6b")
        save_checkpoint(d, cfg, params)
        del params
        byte_level_tokenizer(d)
        base = ["-m", d, "-p", ENTRY_TEXT, "--lang", "en", "--temp", "0", "--max-tokens",
                str(PRECISION_CLI_FRAMES), "--verbose"]
        for label, flags in (("--quantize int4", ["--quantize", "int4"]),
                             ("--quantize int4 --kv-quant", ["--quantize", "int4", "--kv-quant"]),
                             ("--mtp-quantize int8", ["--mtp-quantize", "int8"]),
                             ("--mtp-quantize auto", ["--mtp-quantize", "auto"]),
                             ("--spec-k 4", ["--spec-k", "4"]),
                             ("--spec-k 4 --kv-quant", ["--spec-k", "4", "--kv-quant"]),
                             ("--quantize int4 --spec-k 4 --kv-quant",
                              ["--quantize", "int4", "--spec-k", "4", "--kv-quant"]),
                             ("--mtp-quantize int8 --spec-k 4",
                              ["--mtp-quantize", "int8", "--spec-k", "4"]),
                             ("--quantize int4 --frame-fused on",
                              ["--quantize", "int4", "--frame-fused", "on"]),
                             ("--mtp-quantize int8 --frame-fused on",
                              ["--mtp-quantize", "int8", "--frame-fused", "on"])):
            out_wav = os.path.join(tmp, f"p{len(counts)}.wav")
            reset_launches()
            t0 = time.perf_counter()
            rc, out, err = run_cli(base + flags + ["-o", out_wav])
            wall = time.perf_counter() - t0
            m = SUMMARY.search(out)
            if rc != 0 or m is None:
                raise RuntimeError(f"CLI {label}: exit {rc}\n{out}\n{err}")
            decode_ms, n = float(m.group(1)), int(m.group(2))
            pcm = check_wav(out_wav, f"CLI {label}")
            frames = pcm.size // SAMPLES_PER_FRAME
            if m.group(3) is not None:  # spec: K1 after a fallback, the B=1 chain once, K6 and K5 per iteration
                it, fallback = int(m.group(3)), m.group(5) is not None
                seq = n - 1 - it * 4
                chain = "K3" if flags[:2] == ["--spec-k", "4"] else "K2"  # bf16 trunks: K3
                want = counts_of(K1=seq + fallback, **{chain: 1 + seq}, K5=it, K6=it)
                ms[label] = decode_ms / frames  # per committed frame, random drafts rejected
            else:  # --frame-fused on: every decoded frame one K7 (JAX's gate admits both)
                want = counts_of(K7=n) if "--frame-fused" in flags else counts_of(K1=n, K2=n)
                ms[label] = decode_ms / n
            counts[label] = check_launches(f"CLI {label} ({n} frames decoded)", want)
            log(f"CLI {label}: exit 0, {pcm.size / 24000:.2f} s of audio ({frames} frames), {n} "
                f"frames decoded, {decode_ms / n:.3f} ms per decoded frame, {decode_ms / frames:.3f} "
                f"per committed frame, {wall:.2f} s of wall time [{card_line}]")
    torch.cuda.empty_cache()
    return counts, ms


def precision_17b(tok, card_line):
    """Short 1.7B requests at ``quantize="int4"`` (one K1 int4 and one K3
    int4 per frame) and at an unset ``quantize`` with
    ``mtp_quantize="int8"`` (K1 bf16 and K3 on the int8 trunk with bf16
    heads), K8 on each prefill; then each engine's batches and pool
    (batched_runs: K4 int4 / bf16, K5 on the int4 trunk / the int8 trunk
    with bf16 heads, on K3's float32 cache).  Returns ({label: launch
    counts}, {label: ms per frame})."""
    cfg = voice_config()
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    counts, ms = {}, {}
    for label, kw, unit in (("--quantize int4", dict(quantize="int4"), torch.uint8),
                            ("--mtp-quantize int8", dict(mtp_quantize="int8"), torch.bfloat16)):
        t0 = time.perf_counter()
        eng = TTSEngine(config=cfg, params=params, tokenizer=tok, **kw)
        if not eng.is_ready():
            raise RuntimeError(f"1.7B engine at {kw}: {eng.get_error()}")
        if eng.params["talker"]["fused_step"].wqkv.dtype != unit or b1_chain(eng) != "K3":
            raise RuntimeError(f"the 1.7B engine at {kw} does not pack {unit} units or route B=1 "
                               "to K3")
        torch.cuda.synchronize()
        log(f"engine: 1.7B preset (talker attn_impl=pallas), {label}, built in "
            f"{time.perf_counter() - t0:.1f} s [{card_line}]")
        reset_launches()
        r = eng.synthesize(max_tokens=24, seed=SEED, **B1_REQUESTS[1])
        m = r.metrics
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"bad 1.7B {label} synthesis output")
        layers = cfg.talker.transformer.num_layers
        counts[label] = check_launches(
            f"1.7B {label} request (one K1 and one K3 per frame, K8 per prefill layer)",
            counts_of(K1=m.decoded_frames, K3=m.decoded_frames, K8=layers))
        ms[label] = m.stage_seconds["decode"] * 1e3 / max(m.decoded_frames, 1)
        log(f"1.7B {label} synthesize: {m.frames} frames ({m.decoded_frames} decoded), "
            f"{ms[label]:.3f} ms/frame decode, RTF {m.rtf:.2f}x, TTFA "
            f"{m.ttfa_seconds * 1e3:.1f} ms [{card_line}]")
        counts[f"1.7B batched {label}"] = batched_runs(eng, f"1.7B {label}", card_line)
        del eng
        torch.cuda.empty_cache()
    del params
    return counts, ms


def precision_phase(tok, gen, card_line, spec_counts):
    """Phase 15: every weight precision on the card.  The kernel checks
    (precision_kernel_checks, precision_batched_checks), the CLI under each
    precision flag set (precision_cli; ``spec_counts``: cli_phase's int4
    spec runs), 1.7B int4 and mixed requests, batches and pools
    (precision_17b) and the 0.6B engines' batches and pools
    (precision_engines).  Fails if an instance never launched on those main
    paths.  Returns (launch counts by report key, checks, bounds)."""
    t0 = time.perf_counter()
    checks, bounds = precision_kernel_checks(gen, card_line)
    more_checks, more_bounds = precision_batched_checks(gen)
    checks.update(more_checks)
    bounds.update(more_bounds)
    cli_counts, cli_ms = precision_cli(tok, card_line)
    counts_17b, ms_17b = precision_17b(tok, card_line)
    engine_counts = precision_engines(tok, card_line)
    ids = {k: KERNEL_IDS.index(k) for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
    spec4 = spec_counts["--quantize int4 --spec-k 4"]
    paths = {
        "K1 int4": cli_counts["--quantize int4"][ids["K1"]]
        + counts_17b["--quantize int4"][ids["K1"]],
        "K1 int4 kvq": cli_counts["--quantize int4 --kv-quant"][ids["K1"]],
        "K2 int4": cli_counts["--quantize int4"][ids["K2"]]
        + cli_counts["--quantize int4 --kv-quant"][ids["K2"]],
        "K2 int8 trunk, bf16 heads": cli_counts["--mtp-quantize int8"][ids["K2"]],
        "K2 int4 trunk, bf16 heads": cli_counts["--mtp-quantize auto"][ids["K2"]],
        "K3 int4": counts_17b["--quantize int4"][ids["K3"]],
        "K3 int8 trunk, bf16 heads": counts_17b["--mtp-quantize int8"][ids["K3"]],
        "K6 bf16": cli_counts["--spec-k 4"][ids["K6"]],
        "K6 bf16 kvq": cli_counts["--spec-k 4 --kv-quant"][ids["K6"]],
        "K4 int4": engine_counts["K4 int4"][ids["K4"]]
        + counts_17b["1.7B batched --quantize int4"][ids["K4"]],
        "K5 int4": engine_counts["K5 int4"][ids["K5"]]
        + engine_counts["K5 int4 alt trunk, int8 heads"][ids["K5"]]
        + counts_17b["1.7B batched --quantize int4"][ids["K5"]] + spec4[ids["K5"]],
        "K5 int8 trunk, bf16 heads": engine_counts["K5 int8 trunk, bf16 heads"][ids["K5"]]
        + counts_17b["1.7B batched --mtp-quantize int8"][ids["K5"]]
        + cli_counts["--mtp-quantize int8 --spec-k 4"][ids["K5"]],
        "K5 int4 trunk, bf16 heads": engine_counts["K5 int4 trunk, bf16 heads"][ids["K5"]]
        + spec_counts["without --quantize, --mtp-quantize int4 --spec-k 4"][ids["K5"]],
        "K6 int4": spec4[ids["K6"]],
        "K6 int4 kvq": cli_counts["--quantize int4 --spec-k 4 --kv-quant"][ids["K6"]],
    }
    # K7 at the new unit mixes on the CLI (phase 16 adds its engines' frames)
    k7 = KERNEL_IDS.index("K7")
    frames = {"K7 int4 units": cli_counts["--quantize int4 --frame-fused on"][k7],
              "K7 bf16 talker, int8 trunk": cli_counts["--mtp-quantize int8 --frame-fused on"][k7]}
    unlaunched = [k for k, n in paths.items() if not n]
    if unlaunched:
        raise RuntimeError(f"the precision flags' main paths never launched {unlaunched}")
    log("ms/frame per flag set (CLI, 0.6B, greedy, decode only; spec: per committed frame): "
        + "; ".join(
        f"{k}: {v:.3f}" for k, v in cli_ms.items()) + "; 1.7B: " + "; ".join(
        f"{k}: {v:.3f}" for k, v in ms_17b.items()) + f" [{card_line}]")
    log(f"precision phase: {time.perf_counter() - t0:.1f} s [{card_line}]")
    return paths, checks, bounds, frames


# ---------------------------------------------------------------------------
# Phase 16: K7 at every unit mix, and calls past 32 rows
# ---------------------------------------------------------------------------

# K7's unit mixes besides the int8 talker beside the int8 trunk: report key
# -> (talker units, trunk units, the engine flags that build it); the
# lm_head and heads are bf16 beside a bf16 talker, else int8
K7_MIXES = {
    "K7 int4 units": ("int4", "int4", dict(quantize="int4")),
    "K7 int8 talker, int4 trunk": ("int8", "int4", dict(quantize="int8", mtp_quantize="int4")),
    "K7 int4 talker, int8 trunk": ("int4", "int8", dict(quantize="int4", mtp_quantize="int8")),
    "K7 bf16 talker, int8 trunk": ("bf16", "int8", dict(mtp_quantize="int8")),
    "K7 bf16 talker, int4 trunk": ("bf16", "int4", dict(mtp_quantize="int4")),
}
UNIT_DTYPES = {"int8": torch.int8, "int4": torch.uint8, "bf16": torch.bfloat16}
PAST_32_FRAMES = 16  # frames of each batch past 32 rows
PAST_32_SMALL = 8  # the rows a launch takes in the batch it is held to
PAST_32_POOL_FRAMES = 4  # per request in the pools past 32 rows


def frame_mix_checks(gen, mixes=tuple(K7_MIXES)):
    """K7 at each unit mix of K7_MIXES at the 0.6B widths: against the
    composition K2 -> float32 x -> K1 -> norm+lm_head of the same mix, bit
    for bit, on bf16 (T=256 pos 255, T=2560 pos 2559), float32 and int8
    talker caches and on a one-slot and a narrow one-slot ring (each set's
    stages of its own row bytes and scale floats); against its plain
    version on the bf16 and the int8 cache, sampled (timed beside the
    composition) and greedy.  ``mixes``: the report keys to check.  Returns
    (checks, bounds) by report key (the int8 cache's key ends in " kvq")."""
    cfg = QWEN3_TTS_06B
    checks, bounds = {}, {}
    for key in mixes:
        talker, trunk, _ = K7_MIXES[key]
        packs = frame_packs(cfg, gen, talker, trunk)
        p = K7.frame_plan(*packs, 256, torch.bfloat16).plan
        log(f"{key} plan: {p.n_slots} ring slots of {p.slot_bytes} B, stage rows {p.stage_rows} "
            f"(trunk and heads, then talker and lm_head), {p.slot_rows} scale floats a slot, "
            f"{p.smem_bytes} B of dynamic shared memory [{CARD}]")
        frames = check_k7_composition(packs, 256, 255, torch.bfloat16, gen, inputs=4)
        frames += check_k7_composition(packs, 2560, 2559, torch.bfloat16, gen, inputs=1)
        frames += check_k7_composition(packs, 256, 64, torch.float32, gen, inputs=2)
        frames += check_k7_composition(packs, 256, 255, torch.int8, gen, inputs=2)
        for narrow in (False, True):
            frames += one_slot_ring(lambda: check_k7_composition(
                packs, 256, 255, torch.bfloat16, gen, inputs=1), narrow=narrow)
        knobs = K7_KNOBS[1]
        err, ms, plain_ms, comp_ms = check_k7_plain(packs, 256, 255, knobs, gen, iters=10)
        check_k7_plain(packs, 256, 255, K7_KNOBS[0], gen)
        errq, msq, plainq, compq = check_k7_plain(packs, 256, 255, knobs, gen, iters=10,
                                                  cache_dtype=torch.int8)
        checks[key] = [(err, ms, plain_ms)]
        checks[f"{key} kvq"] = [(errq, msq, plainq)]
        bounds[key] = frame_bound(packs, 255, torch.bfloat16)
        bounds[f"{key} kvq"] = frame_bound(packs, 255, torch.int8)
        log(f"{key}: {frames} frames equal to the composition bit for bit; T=256 pos 255 "
            f"sampled: K7 {ms:.4f} ms (composition {comp_ms:.4f}), int8 cache {msq:.4f} "
            f"(composition {compq:.4f}) [{CARD}]")
        del packs
        torch.cuda.empty_cache()
    return checks, bounds


def frame_mix_engines(tok, card_line):
    """0.6B ``frame_fused=True`` engines at each mix's flags (K7_MIXES), with
    and without ``kv_quant``: a greedy and a sampled request each, every
    decoded frame one K7 launch (``frame_fused_frames`` equal to the decoded
    frames; no K1, K2 or K3), as JAX's frame gate admits these mixes.
    Returns launch counts by report key."""
    cfg = QWEN3_TTS_06B
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    counts = {}
    for key, (talker, trunk, flags) in K7_MIXES.items():
        for kvq in (False, True):
            eng = TTSEngine(config=cfg, params=params, tokenizer=tok, frame_fused=True,
                            kv_quant=kvq, **flags)
            if not eng.is_ready():
                raise RuntimeError(f"0.6B frame_fused engine at {flags}: {eng.get_error()}")
            units = (eng.params["talker"]["fused_step"].wqkv.dtype,
                     eng.params["code_predictor"]["fused_step"].wqkv.dtype)
            if units != (UNIT_DTYPES[talker], UNIT_DTYPES[trunk]):
                raise RuntimeError(f"the 0.6B engine at {flags} packs {units}, not {key}")
            reset_launches()
            decoded, ms = 0, []
            for req in B1_REQUESTS[:2]:
                r = eng.synthesize(max_tokens=24, seed=SEED, **req)
                m = r.metrics
                if (m.frame_fused_frames != m.decoded_frames or not np.isfinite(r.audio).all()
                        or r.codes.shape[1:] != (16,)):
                    raise RuntimeError(f"frame_fused at {flags} kv_quant={kvq}: a frame left K7 "
                                       f"({m.frame_fused_frames} of {m.decoded_frames}), or bad "
                                       "output")
                decoded += m.decoded_frames
                ms.append(m.stage_seconds["decode"] * 1e3 / max(m.decoded_frames, 1))
            label = f"{key}{' kvq' if kvq else ''}"
            counts[label] = check_launches(f"0.6B frame_fused {flags} kv_quant={kvq} (one K7 per "
                                           "decoded frame)", counts_of(K7=decoded))
            log(f"0.6B frame_fused at {flags} kv_quant={kvq}: {decoded} frames decoded, all by "
                f"K7; {[round(x, 3) for x in ms]} ms/frame decode [{card_line}]")
            del eng
    del params
    torch.cuda.empty_cache()
    return counts


def batch_rows_equal(eng, B, label, card_line, frames=PAST_32_FRAMES):
    """``synthesize_batch`` of B streams (B > 32: K4 and K5 split into
    ``persistent.row_launches(B)`` launches a frame; texts cycling through
    BATCH_TEXTS, per-stream seeds), then the same batch with each launch
    cut to at most PAST_32_SMALL rows: every stream's codes and audio equal
    bit for bit, so no row depends on the launch that holds it.  (Batches
    of other sizes are no reference: the plain prefill's products take
    another shape there, and cuBLAS may round them otherwise.)  Returns the
    first batch's launch counts."""
    texts = [BATCH_TEXTS[b % len(BATCH_TEXTS)] for b in range(B)]
    kw = dict(language="en", temperature=0.8, top_k=50, top_p=0.95, max_tokens=frames)
    reset_launches()
    t0 = time.perf_counter()
    big = eng.synthesize_batch(texts, seed=list(range(B)), **kw)
    wall = time.perf_counter() - t0
    d = big[0].metrics.decoded_frames
    n = len(persistent.row_launches(B))
    counts = check_launches(f"{label} synthesize_batch B={B} ({d} batched frames, {n} launches "
                            "of K4 and of K5 a frame)",
                            with_prefills(eng, counts_of(K4=n * d, K5=n * d)))
    for r in big:
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"{label}: bad synthesize_batch output at B={B}")
    launches = [nb for _, nb in persistent.row_launches(B)]
    real = persistent.LAUNCH_ROWS
    persistent.LAUNCH_ROWS = PAST_32_SMALL
    try:
        small = eng.synthesize_batch(texts, seed=list(range(B)), **kw)
        narrow = [nb for _, nb in persistent.row_launches(B)]
    finally:
        persistent.LAUNCH_ROWS = real
    same = [np.array_equal(a.codes, b.codes) and np.array_equal(a.audio, b.audio)
            for a, b in zip(big, small)]
    ms = big[0].metrics.stage_seconds["decode"] * 1e3 / d
    log(f"{label} synthesize_batch B={B} ({n} launches of {launches} rows a kernel): {ms:.3f} ms "
        f"per batched frame decode, {wall:.2f} s of wall time; each stream's codes and audio "
        f"equal to the batch in launches of {narrow} rows: {sum(same)}/{B} -> "
        f"{'ok' if all(same) else 'FAIL'} [{card_line}]")
    if not all(same):
        raise RuntimeError(f"{label} B={B}: streams {[b for b, ok in enumerate(same) if not ok]} "
                           f"differ from the batch in launches of at most {PAST_32_SMALL} rows")
    figure(f"{label} B={B} ms per batched frame", ms)
    return counts


def pool_rows_equal(eng, spec_eng, card_line):
    """A pool of 40 slots (K4 and K5 in two launches of 20 rows a frame) and
    a spec pool of 12 slots x spec_k=4 (48 rows: K6 in two launches of 6
    streams, K5 in two of 24 rows an iteration), each serving one request
    more than it has slots, every fourth greedy: each greedy request's codes
    equal ``synthesize`` at B=1 (a row of at most 32).  Returns the launch
    counts."""
    counts = []
    for label, pool_kw, per_chunk in (
            ("pool of 40", dict(engine=eng, pool_size=40, chunk_len=4), 4),
            (f"spec pool 12 x {SPEC_K}", dict(engine=spec_eng, pool_size=12, spec_k=SPEC_K,
                                              spec_iters=POOL_SPEC_ITERS), POOL_SPEC_ITERS)):
        p = ContinuousBatcher(kv_bucket=eng.kv_ladder[0], **pool_kw)
        try:
            reset_launches()
            t0 = time.perf_counter()
            reqs = [(f"{BATCH_TEXTS[i % len(BATCH_TEXTS)]}, request {i}",
                     0.0 if i % 4 == 0 else 0.8) for i in range(p.pool_size + 1)]
            futs = [p.submit(text, language="en", temperature=temp, top_k=50, top_p=0.95,
                             max_tokens=PAST_32_POOL_FRAMES, seed=SEED + i)
                    for i, (text, temp) in enumerate(reqs)]
            got = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            chunks = p.stats["chunks"]
            for r in got:
                if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                        r.audio).all():
                    raise RuntimeError(f"{label}: bad result")
            if "spec" in label:
                rows = p.pool_size * SPEC_K
                k6 = len(persistent.row_launches(p.pool_size, SPEC_K))
                k5 = len(persistent.row_launches(rows))
                want = counts_of(K2=len(reqs), K5=k5 * chunks * per_chunk,
                                 K6=k6 * chunks * per_chunk)
            else:
                n = len(persistent.row_launches(p.pool_size))
                want = counts_of(K4=n * chunks * per_chunk, K5=n * chunks * per_chunk)
            counts.append(check_launches(f"{label} ({chunks} chunks)", want))
        finally:
            p.shutdown()
        greedy = [(text, r) for (text, temp), r in zip(reqs, got) if temp == 0.0]
        same = [np.array_equal(r.codes, eng.synthesize(text, language="en", temperature=0.0,
                                                        max_tokens=PAST_32_POOL_FRAMES).codes)
                for text, r in greedy]
        log(f"{label}: {len(reqs)} requests in {wall:.2f} s, {chunks} chunks; greedy requests "
            f"equal to synthesize at B=1: {sum(same)}/{len(same)} -> "
            f"{'ok' if all(same) else 'FAIL'} [{card_line}]")
        if not all(same):
            raise RuntimeError(f"{label}: a greedy request differs from synthesize at B=1")
    return [sum(c) for c in zip(*counts)]


def split_rows_checks(gen):
    """K4, K5 and K6 past 32 rows at the 0.6B widths (``rows_past_32``'s
    kernels): at 40 and 64 rows, each row of the split call (and each cache
    row it writes) equal bit for bit to the same row of calls of at most 32
    rows on copies of the caches (rows 0..31, then the rest: not the split's
    own launches); then each timed beside one launch of its split's rows
    (CUDA events), with the bound of the call's work.  Returns {label:
    (split ms, launch ms, launches, bound ms)}."""
    cfg = QWEN3_TTS_06B
    t, cp = cfg.talker.transformer, cfg.code_predictor
    mt = cp.transformer
    fw, mfw = packed_trunk(t, gen), packed_trunk(mt, gen)
    n, V, H = cp.num_steps, cp.subcode_vocab_size, mt.hidden_size
    heads = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)))
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    out = {}

    def compare(label, whole, parts):
        same = all(bool(torch.equal(a, b)) for a, b in zip(whole, parts))
        log(f"{label}: every row (and cache row) equal bit for bit to calls of 32 rows and the "
            f"rest -> {'ok' if same else 'FAIL'} [{CARD}]")
        if not same:
            raise RuntimeError(f"{label}: a row of the split call differs from a call of at most "
                               "32 rows")

    for B in (40, 64):
        x, kc, vc, pos = k4_inputs(t, B, 512, torch.bfloat16, gen)
        pos = torch.tensor(pos, device=DEV)
        ck = clone_all([kc, vc])
        xo = K1.fused_decode_step_batched(t, fw, x, pos, *ck)[0]
        pieces = []
        for r0, r1 in ((0, 32), (32, B)):
            cr = [c[:, r0:r1].clone() for c in (kc, vc)]
            pieces.append((K1.fused_decode_step_batched(t, fw, x[r0:r1], pos[r0:r1], *cr)[0], cr))
        compare(f"K4 0.6B talker B={B} T=512", [xo, *ck],
                [torch.cat([p[0] for p in pieces]),
                 *[torch.cat([p[1][i] for p in pieces], dim=1) for i in range(2)]])
        launches = persistent.row_launches(B)
        nb = launches[0][1]
        out[f"K4 B={B}"] = (
            time_ms(lambda: K1.fused_decode_step_batched(t, fw, x, pos, *ck), 10),
            time_ms(lambda: K1.fused_decode_step_batched(t, fw, x[:nb], pos[:nb], *ck), 10),
            len(launches),
            step_bound(t, fw, B, [min(int(p), 511) for p in pos], 1, torch.bfloat16)[0])

        S, streams = 4, B // 4
        starts = [K4_POSITIONS[b % len(K4_POSITIONS)] for b in range(streams)]
        x6, kc6, vc6, st6 = k6_inputs(t, streams, S, 512, starts, torch.bfloat16, gen)
        ck6 = clone_all([kc6, vc6])
        xo6 = K6.fused_verify_step(t, fw, x6, st6, *ck6)[0]
        pieces = []
        for s0, s1 in ((0, 8), (8, streams)):
            cr = [c[:, s0:s1].clone() for c in (kc6, vc6)]
            pieces.append((K6.fused_verify_step(t, fw, x6[s0:s1], st6[s0:s1], *cr)[0], cr))
        compare(f"K6 0.6B talker {streams} x {S} rows T=512", [xo6, *ck6],
                [torch.cat([p[0] for p in pieces]),
                 *[torch.cat([p[1][i] for p in pieces], dim=1) for i in range(2)]])
        launches = persistent.row_launches(streams, S)
        sb = launches[0][1]
        one = [c[:, :sb].contiguous() for c in ck6]
        out[f"K6 {streams} x {S}"] = (
            time_ms(lambda: K6.fused_verify_step(t, fw, x6, st6, *ck6), 10),
            time_ms(lambda: K6.fused_verify_step(t, fw, x6[:sb], st6[:sb], *one), 10),
            len(launches), step_bound(t, fw, B, starts, S, torch.bfloat16)[0])
        del x, kc, vc, ck, x6, kc6, vc6, ck6, one, pieces

        knobs = [K5_KNOBS[b % len(K5_KNOBS)] for b in range(B)]
        lh = (torch.randn((B, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((B, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        noise = gumbel_noise((n, B, V), gen, DEV)

        def k5(r0, r1):
            return K2.fused_mtp_chain_batched(mt, mfw, fnorm, heads, tables, lh[r0:r1], c0[r0:r1],
                                              noise[:, r0:r1], *zip(*knobs[r0:r1]),
                                              cache_dtype=torch.bfloat16)

        whole = k5(0, B)
        parts = [k5(0, 32), k5(32, B)]
        compare(f"K5 0.6B chain B={B} mixed knobs", list(whole),
                [torch.cat([p[i] for p in parts]) for i in range(2)])
        launches = persistent.row_launches(B)
        nb = launches[0][1]
        out[f"K5 B={B}"] = (time_ms(lambda: k5(0, B), 3), time_ms(lambda: k5(0, nb), 3),
                            len(launches), chain_bound(mt, mfw, heads, B)[0])
    for label, (ms, one, k, least) in out.items():
        log(f"{label}: {ms:.3f} ms in {k} launches; one launch of its rows {one:.3f} ms "
            f"(x{k}: {k * one:.3f}); bound {least:.4f} ms [{CARD}]")
    return out


def finish_phase(tok, gen, card_line):
    """Phase 16: K7 at every unit mix the engine builds (frame_mix_checks,
    frame_mix_engines) and K4, K5 and K6 past 32 rows (split_rows_checks).
    The batches, pools and CLI runs past 32 rows and at the new mixes ride
    on the engines of the phases that build them (main's int8 engines,
    precision_engines, precision_cli, bf16_17b).  Returns (launch counts,
    checks, bounds) by report key."""
    t0 = time.perf_counter()
    checks, bounds = frame_mix_checks(gen)
    counts = frame_mix_engines(tok, card_line)
    split_rows_checks(gen)
    log(f"phase 16 (K7 mixes, past 32 rows): {time.perf_counter() - t0:.1f} s [{card_line}]")
    return counts, checks, bounds


B1_REQUESTS = [
    dict(text="hello world", language="en", temperature=0.0),
    dict(text="hello world, hello world", language="en", temperature=0.8, top_k=50, top_p=0.95),
    dict(text="你好，世界", language="zh", temperature=0.8, top_k=50, top_p=0.95),
]


# The training slice (phase 17), at the 0.6B preset's full depth with random
# bf16 weights from the seed: the train step on a batch of TRAIN_B rows of
# TRAIN_TEXT text tokens and TRAIN_FRAMES frames (10 s of audio), each row
# with 60-119 real frames so that its EOS target lies inside the batch
TRAIN_B, TRAIN_TEXT, TRAIN_FRAMES = 4, 16, 120
TRAIN_STEPS, TRAIN_LR = 10, 1e-3  # the JAX package's hardware smoke's learning rate
# the step-0 loss in bf16 against the same function on a float32 copy of the
# params: every product sums in float32 on both sides, so only the bf16
# rounding of activations between the products differs, and the loss is a
# mean of ~6k cross-entropies: 1.2e-6 to 4.7e-6 relative over the loss and
# its two parts (H100); a wrong mask, target or schedule moves it by O(1)
TRAIN_LOSS_REL = 1e-4
# the gradients of lm_head, layer 0's wq, the MTP heads and text_embed, bf16
# against float32, by cosine: 0.99964 to 0.99988 (H100)
TRAIN_GRAD_COS = 0.995
# tts_loss under no grad with the talker on K8 against attend_xla's: K8 keeps
# the softmax weights in float32 where attend_xla rounds them to bf16 before
# P.V, ~2^-9 relative per output, compounded over 28 layers: 5.1e-5 (H100)
K8_LOSS_REL = 1e-3
# the draft trainer with its teacher on K8: TEACHER_B rows of TEACHER_FRAMES
# frames (S = T = prompt + frames), d_model 512, DRAFT_STEPS Adam steps
TEACHER_B, TEACHER_FRAMES, DRAFT_STEPS, DRAFT_LR = 8, 128, 20, 3e-3
# the tool end to end on a 0.6B checkpoint
TOOL_ARGS = ("--frames", "32", "--temperatures", "0.0", "--steps", "20")
TOOL_TEXT = "hello world, a draft trained on this checkpoint"


def train_batch(B, text, frames, gen):
    """A seeded right-padded batch on the card: text lengths in [text/2,
    text], real frames in [frames/2, frames - 1] (the EOS target inside)."""
    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV)

    return {"text_ids": draw(0, 150000, (B, text)), "text_len": draw(text // 2, text + 1, (B,)),
            "codes": draw(0, 2048, (B, frames, 16)),
            "num_frames": draw(frames // 2, frames, (B,))}


def pallas_talker(cfg):
    """``cfg`` with the talker's attention on K8."""
    t = cfg.talker
    return dataclasses.replace(cfg, talker=dataclasses.replace(
        t, transformer=dataclasses.replace(t.transformer, attn_impl="pallas")))


def float32_model(cfg, params):
    """A float32 copy of the modules the loss reads, and the config that runs
    them in float32."""
    def f32(t):
        return dataclasses.replace(t, dtype="float32")

    cfg32 = dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, transformer=f32(cfg.talker.transformer)),
        code_predictor=dataclasses.replace(
            cfg.code_predictor, transformer=f32(cfg.code_predictor.transformer)))

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        return node.detach().float().requires_grad_(True)

    return cfg32, {k: copy(params[k]) for k in ("talker", "code_predictor", "embeddings")}


GRAD_LEAVES = {  # the leaves whose step-0 gradients are compared
    "lm_head": lambda p: p["talker"]["lm_head"],
    "talker wq, layer 0": lambda p: p["talker"]["transformer"]["layers"]["wq"],
    "MTP heads": lambda p: p["code_predictor"]["heads"],
    "text_embed": lambda p: p["embeddings"]["text_embed"],
}


def loss_and_grads(cfg, params, batch):
    """tts_loss and the GRAD_LEAVES' gradients (float32 copies; layer 0 of
    wq); the leaves' .grad are cleared after."""
    m = tts_loss(cfg, params, *(batch[k] for k in ("text_ids", "text_len", "codes",
                                                      "num_frames")))
    m.loss.backward()
    grads = {}
    for name, leaf in GRAD_LEAVES.items():
        g = leaf(params).grad
        grads[name] = (g[0] if name.startswith("talker wq") else g).float().clone()
    for p in param_leaves(params):
        p.grad = None
    return LossMetrics(*(float(x.detach()) for x in m)), grads


def cosine(a, b) -> float:
    return float((a * b).sum() / (a.norm() * b.norm()))


def mesh_train_step(cfg, params, batch, card_line):
    """Beside the build: one data-parallel step on ``make_mesh(2, 1)`` (the
    batch's rows over two data groups on this card) against the one-device
    step on the same batch, both on float32 copies of the params, so that
    only the groups' summation order differs (in bf16 the groups' gradients
    accumulate in bf16): the loss and the updated lm_head within
    TRAIN_LOSS_REL; a second mesh step timed, peak memory over both."""
    tx = make_optimizer(learning_rate=TRAIN_LR)
    cfg32, p = float32_model(cfg, params)
    step = make_train_step(cfg32, tx)
    one, m1 = step(init_train_state(p, tx), batch)
    loss1, lm1 = float(m1.loss), one.params["talker"]["lm_head"].detach().clone()
    del one, p
    torch.cuda.empty_cache()
    _, p = float32_model(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = shard_train_state(card_mesh(2, 1), init_train_state(p, tx), tx)
    state, m2 = step(state, batch)
    loss2, lm2 = float(m2.loss), state.params["talker"]["lm_head"].detach().clone()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m.loss)  # a sync
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, p
    torch.cuda.empty_cache()
    rel_loss = abs(loss2 - loss1) / abs(loss1)
    rel_lm = float((lm2 - lm1).norm() / lm1.norm())
    ok = rel_loss <= TRAIN_LOSS_REL and rel_lm <= TRAIN_LOSS_REL
    frames = int(batch["num_frames"].sum())
    log(f"data-parallel train step on make_mesh(2, 1) ({cfg.name}, float32 copies, B={TRAIN_B}: "
        f"2 rows a group; beside the build): loss {loss2:.6f} against the one-device step's "
        f"{loss1:.6f}, "
        f"relative {rel_loss:.2e}; updated lm_head relative {rel_lm:.2e} (limit "
        f"{TRAIN_LOSS_REL}); {ms:.1f} ms per mesh step (the second), {frames / ms * 1e3:.1f} "
        f"frames/s, peak {peak:.2f} GiB allocated -> {'ok' if ok else 'FAIL'} [{card_line}]")
    if not ok:
        raise RuntimeError("data-parallel train step disagrees with the one-device step")


def train_steps(cfg, gen, card_line, d):
    """Phase 17 (a) and (b): the 0.6B train step, bf16 against float32 at
    step 0, the talker on K8 refused under grad and equal without it, then
    TRAIN_STEPS steps.  Writes the seed's weights to the checkpoint
    directory ``d`` first (ten steps on random codes teach the talker early
    EOS, and the tool's rollouts would come out too short).  Returns (launch
    counts, the trained params)."""
    keys = ("text_ids", "text_len", "codes", "num_frames")
    L = cfg.talker.transformer.num_layers
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    save_checkpoint(d, cfg, params)
    byte_level_tokenizer(d)
    batch = train_batch(TRAIN_B, TRAIN_TEXT, TRAIN_FRAMES, gen)
    frames = int(batch["num_frames"].sum())
    tx = make_optimizer(learning_rate=TRAIN_LR)
    state = init_train_state(params, tx)

    # (a) step 0 in bf16 against a float32 copy of the same params
    m16, g16 = loss_and_grads(cfg, params, batch)
    cfg32, p32 = float32_model(cfg, params)
    m32, g32 = loss_and_grads(cfg32, p32, batch)
    del p32
    torch.cuda.empty_cache()
    rels = {k: abs(a - b) / abs(b) for k, a, b in zip(("loss", "talker", "mtp"), m16, m32)}
    coss = {k: cosine(g16[k], g32[k]) for k in GRAD_LEAVES}
    ok = (max(rels.values()) <= TRAIN_LOSS_REL and min(coss.values()) >= TRAIN_GRAD_COS
          and int(m16.frames) == frames)
    log(f"train step 0 ({cfg.name}, {L} talker layers, B={TRAIN_B}, {TRAIN_TEXT} text tokens, "
        f"{TRAIN_FRAMES} frames, {frames} real): {cfg.talker.transformer.dtype} loss "
        f"{m16.loss:.5f} (talker {m16.talker_loss:.5f}, mtp {m16.mtp_loss:.5f}), float32 "
        f"{m32.loss:.5f} (talker {m32.talker_loss:.5f}, mtp {m32.mtp_loss:.5f}); relative "
        "differences " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + f" (limit {TRAIN_LOSS_REL}); gradient cosines "
        + ", ".join(f"{k} {v:.5f}" for k, v in coss.items())
        + f" (floor {TRAIN_GRAD_COS}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("train step 0: bf16 disagrees with float32")

    # (b) the talker on K8: refused under grad, the xla loss without it
    pcfg = pallas_talker(cfg)
    reset_launches()
    try:
        tts_loss(pcfg, params, *(batch[k] for k in keys))
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
        log(f"tts_loss with the talker on K8 under grad: refused ({e})")
    else:
        raise RuntimeError("tts_loss with the talker on K8 ran under grad")
    with torch.no_grad():
        mp = tts_loss(pcfg, params, *(batch[k] for k in keys))
    counts = check_launches(f"tts_loss with the talker on K8, no grad ({L} K8)",
                            counts_of(K8=L))
    rel = abs(float(mp.loss) - m16.loss) / m16.loss
    log(f"tts_loss, talker on K8, no grad: {float(mp.loss):.5f} against attend_xla's "
        f"{m16.loss:.5f}: relative {rel:.2e} (limit {K8_LOSS_REL})")
    if not rel <= K8_LOSS_REL:
        raise RuntimeError("tts_loss on K8 disagrees with attend_xla")

    # TRAIN_STEPS steps on the batch, the loss falling
    step = make_train_step(cfg, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m.loss))  # a sync
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sum(secs[1:]) / (len(secs) - 1) * 1e3
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0] and state.step == TRAIN_STEPS
    log(f"train steps (AdamW lr {TRAIN_LR}, clip 1.0, {cfg.name} "
        f"{cfg.talker.transformer.dtype}): losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; {ms:.1f} ms per step over the last {TRAIN_STEPS - 1} (first "
        f"{secs[0] * 1e3:.1f} ms), {frames / ms * 1e3:.1f} frames/s ({frames} real frames a "
        f"step), peak {peak:.2f} GiB allocated -> {'ok' if ok else 'FAIL'} [{card_line}]")
    if not ok:
        raise RuntimeError("train steps: the loss did not fall")
    return counts, params


def draft_steps(cfg, params, gen, card_line):
    """Phase 17 (c): K8 at the teacher's shape against its plain version,
    then DRAFT_STEPS draft steps with the teacher pass on K8 and the loss
    falling.  Returns (launch counts, the K8 check)."""
    keys = ("text_ids", "text_len", "codes", "num_frames")
    t = cfg.talker.transformer
    S = prompt_length(None) + TEACHER_FRAMES
    k8 = check_k8("draft teacher", TEACHER_B, S, S, t.num_heads, t.num_kv_heads, "teacher",
                  gen, iters=20)
    pcfg = pallas_talker(cfg)
    dcfg = DraftConfig(hidden_size=t.hidden_size, codec_vocab_size=cfg.talker.codec_vocab_size,
                       subcode_vocab_size=cfg.code_predictor.subcode_vocab_size, dtype=t.dtype)
    dp = init_draft_params(dcfg, gen, DEV)
    batch = train_batch(TEACHER_B, TRAIN_TEXT, TEACHER_FRAMES, gen)
    tx = adam(DRAFT_LR)
    opt = tx.init(dp)
    step = make_draft_train_step(pcfg, dcfg, tx)
    reset_launches()
    with torch.no_grad():
        m0 = draft_loss(pcfg, dcfg, params, dp, *(batch[k] for k in keys))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DRAFT_STEPS):
        dp, opt, m = step(dp, opt, params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DRAFT_STEPS
    counts = check_launches(f"draft trainer, teacher on K8 ({DRAFT_STEPS + 1} teacher passes)",
                            counts_of(K8=(DRAFT_STEPS + 1) * t.num_layers))
    ok = float(m.loss) < float(m0.loss)
    log(f"draft trainer (d_model {dcfg.d_model}, Adam lr {DRAFT_LR}, teacher on K8 at B="
        f"{TEACHER_B}, S=T={S}): loss {float(m0.loss):.4f} -> {float(m.loss):.4f} over "
        f"{DRAFT_STEPS} steps, {ms:.1f} ms per step (the teacher pass included) "
        f"-> {'ok' if ok else 'FAIL'} [{card_line}]")
    if not ok:
        raise RuntimeError("draft trainer: the loss did not fall")
    return counts, k8


def draft_tool(d):
    """Phase 17 (d): ``tools.train_draft`` on the checkpoint ``d``, then a
    spec_k engine on what it wrote drafting with the trained head and
    decoding the sequential engine's greedy codes.  Returns launch counts."""
    out = d + "-draft"
    reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_draft_main(["--model", d, "--out", out, *TOOL_ARGS])
    lines = buf.getvalue().strip().splitlines()
    report = json.loads(lines[-1]) if rc == 0 and lines else {}
    log(f"tools.train_draft {' '.join(TOOL_ARGS)}: rc {rc} in {time.perf_counter() - t0:.1f} "
        f"s: {report}")
    if rc != 0 or not report["loss_after"] < report["loss_before"]:
        raise RuntimeError("tools.train_draft failed or its loss did not fall")
    n = launches()[0]
    counts = check_launches("train_draft's rollouts (bf16 units: one K1 and one K3 a frame)",
                            counts_of(K1=n, K3=n))
    if not n:
        raise RuntimeError("train_draft's rollouts launched no K1")
    eng = TTSEngine(out, spec_k=SPEC_K)
    if not eng.is_ready():
        raise RuntimeError(f"engine on the trained checkpoint: {eng.get_error()}")
    if eng.cfg.draft is None or "draft" not in eng.params:
        raise RuntimeError("the trained checkpoint carries no draft")
    drafted = []
    real = draft_module.draft_predict
    draft_module.draft_predict = lambda *a: (drafted.append(1), real(*a))[1]
    reset_launches()
    kw = dict(language="en", temperature=0.0, max_tokens=32)
    try:
        b = eng.synthesize(TOOL_TEXT, **kw)
    finally:
        draft_module.draft_predict = real
    eng.spec_k = None  # the same engine, sequential
    a = eng.synthesize(TOOL_TEXT, **kw)
    got = launches()
    c = check_launches(f"spec_k={SPEC_K} and sequential on the trained checkpoint", got)
    same = np.array_equal(a.codes, b.codes)
    ok = bool(drafted) and same and got[KERNEL_IDS.index("K6")] and got[KERNEL_IDS.index("K5")]
    log(f"spec_k={SPEC_K} engine on the trained checkpoint: drafted with the trained head "
        f"{len(drafted)} times, greedy codes {'equal' if same else 'UNEQUAL'} to the "
        f"sequential engine's ({len(a.codes)} frames) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("spec engine on the trained checkpoint")
    return [x + y for x, y in zip(counts, c)]


def train_phase(tok, gen, card_line, cfg=QWEN3_TTS_06B):
    """Phase 17: the training path at the 0.6B preset's full depth.  Returns
    (launch counts, the K8 teacher-shape check, bounds)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "qwen3-tts-0.6b")
        counts, params = train_steps(cfg, gen, card_line, d)
        torch.cuda.empty_cache()
        c, k8 = draft_steps(cfg, params, gen, card_line)
        del params
        torch.cuda.empty_cache()
        counts = [x + y + z for x, y, z in zip(counts, c, draft_tool(d))]
    torch.cuda.empty_cache()
    log(f"train phase: {time.perf_counter() - t0:.1f} s [{card_line}]")
    return counts, k8, {"K8 teacher": k8[4]}


# Phase 18: the JAX package's routes outside its step and chain kernels.
# Requests are short: the plain layers run op by op (~0.1 s a frame), and the
# phase's budget is 45 s of the script's clock.
OFF_FRAMES = 16  # 0.6B at mtp_resident=False, B=1 (and B=8, spec, at half)
PLAIN_FRAMES = 4  # the plain talker engines, per request
REACH_LAYERS = 4  # the K8 reach engine's talker depth (cut from 28)
ISTFT_FRAMES, ISTFT_CHUNK = 40, 8  # the iSTFT vocoder's whole run and chunk
ISTFT_REL = 1e-4  # chunked vs whole and card vs CPU, of the largest sample


def resident_off_runs(off_eng, off_spec, card_line):
    """The 0.6B preset at ``mtp_resident=False`` (``--mtp-resident off``):
    the per-step chain, one step kernel launch per chain position past the
    prefix (K1 at B=1, K4 at B=8 and over spec's 4 candidate rows), and no
    chain kernel; greedy spec's codes equal the same engine's sequential
    decode.  Returns (launch counts, B=1 ms/frame)."""
    n = off_eng.cfg.code_predictor.num_steps
    reset_launches()
    r = off_eng.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=OFF_FRAMES)
    m = r.metrics
    if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
            r.audio).all() or not m.decoded_frames:
        raise RuntimeError("0.6B mtp_resident=False: bad B=1 output")
    ms = m.stage_seconds["decode"] * 1e3 / m.decoded_frames
    log(f"0.6B mtp_resident=False B=1: {m.frames} frames ({m.decoded_frames} decoded), "
        f"{ms:.3f} ms/frame decode [{card_line}]")
    counts = [check_launches(f"0.6B mtp_resident=False B=1 ({n} K1 per decoded frame)",
                             counts_of(K1=n * m.decoded_frames))]
    reset_launches()
    rs = off_eng.synthesize_batch(BATCH_TEXTS, temperature=0.0, max_tokens=OFF_FRAMES // 2)
    got = launches()
    k4 = got[KERNEL_IDS.index("K4")]
    frames = sum(x.metrics.frames for x in rs)
    if (any(not np.isfinite(x.audio).all() for x in rs) or k4 % n or k4 < n * max(
            x.metrics.decoded_frames for x in rs) or got != counts_of(K4=k4)):
        raise RuntimeError(f"0.6B mtp_resident=False B=8: launches {got}, {frames} frames")
    log(f"0.6B mtp_resident=False synthesize_batch B=8: {frames} frames, K4 {k4} ({n} a "
        f"batched frame: the talker's and {n - 1} chain positions) [{card_line}]")
    counts.append(got)
    reset_launches()
    r = off_spec.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=OFF_FRAMES // 2)
    got = launches()
    k1, k4, k6 = (got[KERNEL_IDS.index(k)] for k in ("K1", "K4", "K6"))
    if (not np.isfinite(r.audio).all() or not k6 or not k4 or k4 % (n - 1) or k1 % (n - 1)
            or got != counts_of(K1=k1, K4=k4, K6=k6)):
        raise RuntimeError(f"0.6B mtp_resident=False spec_k={SPEC_K}: launches {got}")
    # the same engine decoding the request sequentially (greedy)
    off_spec.spec_k = None
    try:
        seq = off_spec.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=OFF_FRAMES // 2)
    finally:
        off_spec.spec_k = SPEC_K
    agree = int((seq.codes[: len(r.codes)] == r.codes[: len(seq.codes)]).all(axis=1).sum())
    same = np.array_equal(r.codes, seq.codes)
    log(f"0.6B mtp_resident=False spec_k={SPEC_K}: {r.metrics.frames} frames, K6 {k6}, chain "
        f"steps K4 {k4} and K1 {k1} ({n - 1} per chain); greedy codes "
        f"{'equal' if same else 'UNEQUAL'} to the same engine's sequential decode ({agree} of "
        f"{len(seq.codes)} frames agree) [{card_line}]")
    if not same:
        raise RuntimeError("greedy spec on the per-step chain parts from sequential decoding")
    counts.append(got)
    return [sum(c) for c in zip(*counts)], ms


def trunk_step_checks(cfg, gen, card_line):
    """K1 and K4 at the MTP trunk's shape inside the per-step chain: every
    step of a greedy chain (B=1: K1; B=4: K4) against the plain version on a
    copy of its caches, at the trunk's 6 layers (K1's deep limits) and at
    one layer (the one-layer limits, and at least K1's share of tight
    steps).  The plain version runs on the card.  Returns (max abs err,
    greedy agreement with the chain whose every step is the plain version)."""
    from leaxer_qwen3_tts_torch.models import code_predictor as CP

    cp = dataclasses.replace(cfg.code_predictor, resident=False)
    worst, agree = 0.0, []
    for layers, rel_tol, slot_tol in ((cp.transformer.num_layers, K1_DEEP_X_REL,
                                       K1_DEEP_SLOT_ABS),
                                      (K1_SHALLOW_LAYERS, K1_SHALLOW_X_REL, K1_SHALLOW_SLOT_ABS)):
        c = dataclasses.replace(cp, transformer=dataclasses.replace(cp.transformer,
                                                                    num_layers=layers))
        p = CP.init_code_predictor_params(c, gen, DEV)
        p = quantize_params(fuse_params({"code_predictor": p}))["code_predictor"]
        p = CP.prepare_fused_step(c, p)
        H, V, n = c.transformer.hidden_size, c.subcode_vocab_size, c.num_steps
        tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        steps = []
        kernels = (CP.fused_decode_step, CP.fused_decode_step_batched)
        plains = (K1.fused_decode_step_reference, K1.fused_decode_step_batched_reference)

        def checked(kernel, plain):
            def step(t, fw, x, pos, kc, vc):
                xp, kcp, vcp = plain(t, fw, x, pos, kc.clone(), vc.clone())
                out = kernel(t, fw, x, pos, kc, vc)
                err = float((out[0] - xp).abs().max())
                rel = err / float(xp.abs().max())
                slot = float((kc[..., pos, :].float() - kcp[..., pos, :].float()).abs().max())
                steps.append((err, rel, slot))
                return out
            return step

        for B in (1, 4):
            lh = (torch.randn((B, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
            c0 = (torch.randn((B, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
            runs = []
            for wrap in (True, False):
                CP.fused_decode_step, CP.fused_decode_step_batched = (
                    [checked(k, pl) for k, pl in zip(kernels, plains)] if wrap else plains)
                try:
                    runs.append(CP.predict_subcodes(
                        c, p, tables, lh, c0, lambda lg, j: lg.argmax(-1),
                        sp=SamplingParams.create(0.0))[0])
                finally:
                    CP.fused_decode_step, CP.fused_decode_step_batched = kernels
            agree.append(float((runs[0] == runs[1]).float().mean()))
        tight = sum(rel <= K1_TIGHT_REL for _, rel, _ in steps)
        rel = max(r for _, r, _ in steps)
        slot = max(x for _, _, x in steps)
        need = 0 if layers > 1 else len(steps) * K1_TIGHT_MIN // K1_TIGHT_INPUTS
        ok = rel < rel_tol and slot < slot_tol and tight >= need
        worst = max(worst, max(e for e, _, _ in steps))
        log(f"K1 / K4 in the per-step chain, MTP trunk L={layers} T={c.max_seq_len}: "
            f"{len(steps)} steps at B=1 and 4, x max rel {rel:.3e} (tol {rel_tol}), slot "
            f"max_abs_err {slot:.3e} (tol {slot_tol}), tight {tight} (need {need}) -> "
            f"{'ok' if ok else 'FAIL'} [{card_line}]")
        if not ok:
            raise RuntimeError(f"K1 / K4 at the MTP trunk (L={layers}) disagree with their plain "
                               "versions")
    log(f"per-step chains with the kernels vs with the plain version on every step: greedy "
        f"sub-code agreement {[round(a, 3) for a in agree]} (data: a near-tie may flip) "
        f"[{card_line}]")
    return worst, agree


def plain_engine_runs(cfg, params, tok, label, card_line):
    """An engine whose talker decodes on the plain layers (``decode_impl=
    "xla"``) beside its chain: B=1, B=4, a pool of 2 and spec_k=4, every
    output finite and nothing launched.  Returns the B=1 ms/frame."""
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    spec = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8", spec_k=SPEC_K,
                     spec_accept_floor=0.0)
    if "fused_step" in eng.params["talker"]:
        raise RuntimeError(f"{label}: the talker was packed")
    reset_launches()
    r = eng.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=PLAIN_FRAMES)
    outs = [r] + eng.synthesize_batch(BATCH_TEXTS[:4], temperature=0.0, max_tokens=PLAIN_FRAMES)
    pool = ContinuousBatcher(eng, pool_size=2, chunk_len=4, kv_bucket=eng.kv_ladder[0])
    try:
        outs += [f.result(timeout=600) for f in (
            pool.submit(t, temperature=0.0, max_tokens=PLAIN_FRAMES) for t in BATCH_TEXTS[:2])]
    finally:
        pool.shutdown()
    outs.append(spec.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=PLAIN_FRAMES))
    for x in outs:
        if (x.audio.shape != (x.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                x.audio).all() or not len(x.codes)):
            raise RuntimeError(f"{label}: bad output")
    ms = r.metrics.stage_seconds["decode"] * 1e3 / max(r.metrics.decoded_frames, 1)
    log(f"{label}: B=1 {r.metrics.frames} frames, {ms:.3f} ms/frame decode; B=4, a pool of 2 "
        f"and spec_k={SPEC_K}: {sum(len(x.codes) for x in outs[1:])} frames, audio finite "
        f"[{card_line}]")
    check_launches(f"{label} (the plain layers: no kernel)", counts_of())
    del eng, spec
    return ms


def istft_checks(cfg, gen, card_line):
    """The iSTFT vocoder head at the preset's widths (d_model 1024, hop
    2000, n_fft 8000): whole decoding finite and within ISTFT_REL of the
    same on the CPU; chunked decoding at ``left_context_frames`` equal to
    whole decoding within ISTFT_REL.  Returns the whole decoding's ms."""
    from leaxer_qwen3_tts_torch.models.codec12hz import init_vocoder_params, vocode_chunk

    vc = dataclasses.replace(cfg.vocoder, head="istft")
    vp = init_vocoder_params(vc, gen, DEV)
    codes = torch.randint(0, vc.codebook_size, (1, ISTFT_FRAMES, vc.num_codebooks),
                          generator=gen, device=DEV)
    whole = vocoder_forward(vc, vp, codes)
    ms = time_ms(lambda: vocoder_forward(vc, vp, codes), 3, 1)
    ctx, spf = vc.left_context_frames, vc.samples_per_frame
    scale = float(whole.abs().max())
    chunk_err = 0.0
    for start in range(ctx, ISTFT_FRAMES, ISTFT_CHUNK):
        part = vocode_chunk(vc, vp, codes[:, start - ctx:start + ISTFT_CHUNK], ctx)
        chunk_err = max(chunk_err, float((part - whole[:, start * spf:(start + ISTFT_CHUNK) * spf])
                                         .abs().max()))
    cpu = vocoder_forward(vc, flatten_cpu(vp), codes.cpu())
    cpu_err = float((whole.cpu() - cpu).abs().max())
    ok = (bool(torch.isfinite(whole).all()) and whole.shape == (1, ISTFT_FRAMES * spf)
          and chunk_err <= ISTFT_REL * scale and cpu_err <= ISTFT_REL * scale)
    log(f"iSTFT vocoder (d_model {vc.d_model}, hop {spf}, n_fft {vc.istft_overlap * spf}): "
        f"{ISTFT_FRAMES} frames in {ms:.3f} ms, chunks of {ISTFT_CHUNK} at {ctx} frames of context "
        f"max_abs_err {chunk_err:.3e}, card vs CPU {cpu_err:.3e} (tol {ISTFT_REL * scale:.3e}) "
        f"-> {'ok' if ok else 'FAIL'} [{card_line}]")
    if not ok:
        raise RuntimeError("the iSTFT vocoder's chunked or card decoding disagrees")
    return ms


def flatten_cpu(tree):
    """A parameter tree with every tensor copied to the CPU."""
    if isinstance(tree, dict):
        return {k: flatten_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [flatten_cpu(v) for v in tree]
    return tree.cpu()


def reach_engine(cfg, tok):
    """A talker of head_dim 80 with 32 q heads per kv head (its depth cut to
    REACH_LAYERS; the step kernels do not take it, so it decodes unpacked,
    ``decode_impl="xla"``, as JAX leaves it) and ``attn_impl="pallas"``, so
    that its prefill and every decode step attend through K8."""
    t = dataclasses.replace(cfg.talker.transformer, num_layers=REACH_LAYERS, num_heads=32,
                            num_kv_heads=1, head_dim=80, attn_impl="pallas")
    c = dataclasses.replace(cfg, talker=dataclasses.replace(cfg.talker, transformer=t,
                                                            decode_impl="xla"))
    params = init_params(c, seed=SEED, device=DEV, with_speaker_encoder=False)
    return TTSEngine(config=c, params=params, tokenizer=tok, quantize="int8")


def reach_engine_run(eng, card_line):
    """K8 on a main path at a head_dim and group the presets do not use
    (``reach_engine``).  Returns the launch counts."""
    reset_launches()
    r = eng.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=PLAIN_FRAMES)
    if not np.isfinite(r.audio).all() or not r.metrics.decoded_frames:
        raise RuntimeError("K8 reach engine: bad output")
    d = r.metrics.decoded_frames
    log(f"K8 reach engine (talker head_dim 80, 32 q heads per kv head, {REACH_LAYERS} layers): "
        f"{r.metrics.frames} frames [{card_line}]")
    return check_launches(f"K8 reach engine ({REACH_LAYERS} K8 per prefill and per decode "
                          f"step; one K2 per decoded frame)",
                          counts_of(K2=d, K8=REACH_LAYERS * (1 + d)))


def plain_attention_memory(card_line):
    """The plain attention's transient memory at B=32, T=2560 (one decode
    step's layer: q [32, 1, 16, 128] over a bf16 and an int8 cache of 8 kv
    heads), read as the allocator's peak over what was allocated before."""
    from leaxer_qwen3_tts_torch.ops.attention import attend_xla

    B, T, nq, nk, d = 32, 2560, 16, 8, 128
    out = {}
    for dtype in (torch.bfloat16, torch.int8):
        q = torch.randn((B, 1, nq, d), device=DEV).to(torch.bfloat16)
        if dtype == torch.int8:
            k = torch.randint(-127, 128, (B, nk, T, d), device=DEV, dtype=torch.int8)
            scales = torch.rand((B, nk, T), device=DEV)
        else:
            k, scales = torch.randn((B, nk, T, d), device=DEV).to(dtype), None
        mask = torch.ones((B, 1, T), dtype=torch.bool, device=DEV)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        attend_xla(q, k, k, mask, k_scale=scales, v_scale=scales)
        torch.cuda.synchronize()
        out[str(dtype)[6:]] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del q, k, scales, mask
    log("plain attention at B=32 T=2560 (one layer, q [32, 1, 16, 128]): peak over the inputs "
        + ", ".join(f"{k} cache {v:.1f} MiB" for k, v in out.items()) + f" [{card_line}]")
    return out


MESH_FRAMES = 4  # the meshes' plain routes beside the build, per request
MESH_TEXTS = BATCH_TEXTS[:3]


def card_mesh(data, model):
    """``make_mesh(data, model)`` listing this card data x model times."""
    return make_mesh(data, model, devices=[DEV] * (data * model))


def check_mesh_outputs(label, outs, texts, groups, witness, t0, card_line):
    """Finite audio of the codes' length and codes [n, 16] for each request
    (its data group logged), no kernel launched, and, where ``witness`` (by
    text) is given, greedy codes equal to it: a mismatch fails."""
    for r in outs:
        if (r.codes.ndim != 2 or r.codes.shape[1] != 16 or not np.isfinite(r.audio).all()
                or r.audio.shape != (len(r.codes) * SAMPLES_PER_FRAME,)):
            raise RuntimeError(f"{label}: bad output (codes {r.codes.shape}, audio "
                               f"{r.audio.shape})")
    differ = [t for r, t in zip(outs, texts)
              if witness is not None and not np.array_equal(r.codes, witness[t])]
    log(f"{label}: " + "; ".join(f"{t[:20]!r} on data group {g}: {len(r.codes)} frames"
                                 for r, t, g in zip(outs, texts, groups))
        + ("" if witness is None else
           f"; greedy codes equal to make_mesh(1, 1)'s {len(outs) - len(differ)} of {len(outs)}")
        + f"; {time.perf_counter() - t0:.1f} s [{card_line}]")
    if differ:
        raise RuntimeError(f"{label}: greedy codes differ from make_mesh(1, 1)'s for {differ}")
    check_launches(f"{label} (the plain step and the cached chain: no kernel)", counts_of())


def group_log(pool):
    """Record the data group each admitted request lands in: a list of
    (text, group) filled as the pool splices its requests."""
    seen = []
    real = pool._splice_one

    def splice(slot, req, *a):
        seen.append((req.text, pool._group_of(slot)[0]))
        return real(slot, req, *a)

    pool._splice_one = splice
    return seen


def mesh_pool(eng, texts, pool_size, **pool_kw):
    """Greedy requests of ``MESH_FRAMES`` through a pool on ``eng``: (the
    results, each request's data group)."""
    pool = ContinuousBatcher(eng, pool_size=pool_size, chunk_len=MESH_FRAMES,
                             kv_bucket=eng.kv_ladder[0], **pool_kw)
    seen = group_log(pool)
    try:
        outs = [f.result(timeout=900) for f in
                [pool.submit(t, temperature=0.0, max_tokens=MESH_FRAMES) for t in texts]]
    finally:
        pool.shutdown()
    where = dict(seen)
    return outs, [where[t] for t in texts]


def mesh_plain_runs(cfg, params, tok, card_line):
    """Beside the build: the 0.6B meshes' plain routes on this card (the
    JAX engine's routes at B > 1, in pools and at tp=1: the plain step and
    the cached chain, no hand-written kernel).  First the witnesses on
    make_mesh(1, 1), on the same unfused params and plain route, each
    request in the shape a data group of one row gives it: B=1, a pool of
    one slot and a spec pool (spec_k=4) of one slot.  Then the data axis,
    one row or slot a group, each request's greedy codes equal to its
    witness's: ``synthesize_batch`` of 2 on (2, 1); on (2, 2) a pool of 2
    with 3 requests, a spec pool of 2 with 2 and a ``BatchingServer`` with
    2 (one batch).  Each run's seconds logged."""
    t0 = time.perf_counter()
    kw = dict(temperature=0.0, max_tokens=MESH_FRAMES)
    spec = dict(spec_k=SPEC_K, spec_iters=1)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, mesh=card_mesh(1, 1))
    t1 = time.perf_counter()
    reset_launches()
    outs = [eng.synthesize(t, **kw) for t in MESH_TEXTS]
    m = outs[0].metrics
    ms = m.stage_seconds["decode"] * 1e3 / max(m.decoded_frames, 1)
    check_mesh_outputs(f"0.6B make_mesh(1, 1) B=1 ({ms:.1f} ms/frame), the B=1 witness", outs,
                       MESH_TEXTS, [0] * len(outs), None, t1, card_line)
    alone = {t: r.codes for t, r in zip(MESH_TEXTS, outs)}
    witness = {}
    for label, pool_kw, texts in (("a pool of 1", {}, MESH_TEXTS),
                                  (f"a spec pool (spec_k={SPEC_K}) of 1", spec, MESH_TEXTS[:2])):
        t1 = time.perf_counter()
        reset_launches()
        outs, groups = mesh_pool(eng, texts, 1, **pool_kw)
        agree = sum(np.array_equal(r.codes, alone[t]) for r, t in zip(outs, texts))
        check_mesh_outputs(f"0.6B make_mesh(1, 1) {label}, the witness (greedy codes equal to "
                           f"B=1's {agree} of {len(outs)}: data)", outs, texts, groups, None, t1,
                           card_line)
        witness[label] = {t: r.codes for t, r in zip(texts, outs)}
    del eng

    t1 = time.perf_counter()
    reset_launches()
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, mesh=card_mesh(2, 1))
    texts = MESH_TEXTS[:2]
    outs = eng.synthesize_batch(texts, **kw)
    groups = [g for g, rows in enumerate(split_rows(len(texts), 2))
              for _ in range(rows.stop - rows.start)]
    m = outs[0].metrics
    ms = m.stage_seconds["decode"] * 1e3 / max(m.decoded_frames, 1)
    check_mesh_outputs(f"0.6B make_mesh(2, 1) synthesize_batch B=2 ({ms:.1f} ms per batched "
                       "frame)", outs, texts, groups, alone, t1, card_line)
    del eng

    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, mesh=card_mesh(2, 2))
    if "fused_tp" not in eng.params["talker"]:
        raise RuntimeError("0.6B make_mesh(2, 2): no K9 pack")
    for label, pool_kw, texts, wit in (
            ("a pool of 2", {}, MESH_TEXTS, witness["a pool of 1"]),
            (f"a spec pool (spec_k={SPEC_K}) of 2", spec, MESH_TEXTS[:2],
             witness[f"a spec pool (spec_k={SPEC_K}) of 1"])):
        t1 = time.perf_counter()
        reset_launches()
        outs, groups = mesh_pool(eng, texts, 2, **pool_kw)
        check_mesh_outputs(f"0.6B make_mesh(2, 2) {label}", outs, texts, groups, wit, t1,
                           card_line)
    t1 = time.perf_counter()
    reset_launches()
    server = BatchingServer(eng, max_batch=2, max_wait_ms=2000.0)
    try:
        texts = MESH_TEXTS[:2]
        outs = [f.result(timeout=900) for f in [server.submit(t, **kw) for t in texts]]
        batches = server.stats["batches"]
    finally:
        server.shutdown()
    if batches != 1:
        raise RuntimeError(f"0.6B make_mesh(2, 2) server: {batches} batches for 2 requests")
    check_mesh_outputs("0.6B make_mesh(2, 2) BatchingServer, one batch of 2", outs, texts,
                       [0, 1], alone, t1, card_line)
    del eng
    log(f"mesh plain routes (beside the build): {time.perf_counter() - t0:.1f} s [{card_line}]")


PARITY_PRESET = "qwen3-tts-12hz-0.6b-base"
PARITY_FIXTURES = {"int8": "int8", "bf16": None}  # tests/fixtures/parity_0p6b_<name>.npz: quantize
REPORT_FRAMES = 16  # the reports' --max-frames
SPEC_REPORT_TEXT = "hello world"


def report_run(label, main, argv, card_line):
    """``main(argv)`` of a report tool: exit 0 and its one JSON line, which
    is returned and logged with the launches it made (no launch-per-op
    entry)."""
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise RuntimeError(f"{label}: exit {rc}, output {out.getvalue()!r}")
    report = json.loads(lines[-1])
    got = launches()
    multi = {k: n for k, n in ENTRY_CALLS.items() if k in MULTI_ENTRIES}
    if multi:
        raise RuntimeError(f"{label}: the path ran launch-per-op entries {multi}")
    log(f"{label}: {lines[-1]} [{card_line}]")
    log(f"  launches of {label}: " + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, got) if n))
    return report, got


def tools_phase(gate_engines, card_line):
    """Phase 19: the report tools on the card at the 0.6B widths.
    ``parity_check.gate_fixture`` holds the int8 and bf16 engines (built
    beside the build on the JAX tools' fill) against the fixtures the JAX
    tools wrote from the same weights (tests/fixtures/parity_0p6b_*.npz,
    8 frames): each stage's error beside its bound, the codes' agreement and
    first part; one K1 and one K2 (int8) or K3 (bf16 units) per decoded
    frame.  Then ``quality_report`` (int8 against bf16 units) and
    ``spec_report`` (k=4, bf16 units, one text) through their ``main`` on
    the tools' own fill, REPORT_FRAMES frames: exit 0, the JSON line, greedy
    spec equal to sequential.  Returns the gates' launch counts by fixture
    name (the K1, K2 and K3 rows of the report)."""
    t0 = time.perf_counter()
    counts = {}
    for name in list(gate_engines):
        eng = gate_engines.pop(name)
        chain = b1_chain(eng)
        fx = os.path.join(REPO_DIR, "tests", "fixtures", f"parity_0p6b_{name}.npz")
        reset_launches()
        r = parity_check.gate_fixture(
            eng, fx, log=lambda line, n=name: log(f"  parity gate {n}: {line} [{card_line}]"))
        if not r["ok"]:
            raise RuntimeError(f"parity gate {name}: failed {r['failures']}")
        n = r["frames_run"]
        counts[name] = check_launches(f"parity gate {name} (one K1 and one {chain} per decoded "
                                      "frame)", counts_of(K1=n, **{chain: n}))
        del eng
    torch.cuda.empty_cache()
    base = ["--random-preset", PARITY_PRESET, "--max-frames", str(REPORT_FRAMES)]
    _, got = report_run("quality_report (int8 against bf16 units)", quality_report.main, base,
                        card_line)
    if not all(got[KERNEL_IDS.index(k)] for k in ("K1", "K2", "K3")):
        raise RuntimeError("quality_report: the int8 (K1, K2) or bf16 (K1, K3) route never ran")
    with tempfile.TemporaryDirectory() as d:
        texts = os.path.join(d, "texts.txt")
        with open(texts, "w") as f:
            f.write(SPEC_REPORT_TEXT + "\n")
        spec, got = report_run("spec_report (k=4, bf16 units)", spec_report.main,
                               base + ["--k", "4", "--texts", texts], card_line)
    if spec["greedy_parity_vs_sequential"] is not True:
        raise RuntimeError("spec_report: greedy spec decode differs from sequential")
    if not got[KERNEL_IDS.index("K6")] or not got[KERNEL_IDS.index("K5")]:
        raise RuntimeError("spec_report: the verify pass (K6) or its chains (K5) never ran")
    torch.cuda.empty_cache()
    log(f"tools phase: {time.perf_counter() - t0:.1f} s [{card_line}]")
    return counts


def main_engines(cfg, params, tok):
    """The 0.6B engines of phases 6-9 and the resident-off runs, on the
    seed's weights: int8 sequential, spec_k (the fallback off unless a check
    turns it on), spec_k with a trained-draft head of random weights (drawn
    from a generator of its own), frame_fused, and the resident chain off
    (--mtp-resident off: the per-step chain) sequential and with spec_k.
    Packing needs no kernel, so they are built beside the build."""
    gen_draft = torch.Generator(device=DEV)
    gen_draft.manual_seed(SEED + 7)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    spec_eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8",
                         spec_k=SPEC_K, spec_iters=SPEC_ITERS, spec_accept_floor=0.0)
    draft_eng = TTSEngine(config=dataclasses.replace(cfg, draft=DraftConfig()),
                          params=dict(params, draft=init_draft_params(DraftConfig(), gen_draft,
                                                                      DEV)),
                          tokenizer=tok, quantize="int8", spec_k=SPEC_K, spec_iters=SPEC_ITERS,
                          spec_accept_floor=0.0)
    ff_eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8",
                       frame_fused=True)
    off_eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8",
                        mtp_resident=False)
    off_spec = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8",
                         mtp_resident=False, spec_k=SPEC_K, spec_accept_floor=0.0)
    return eng, spec_eng, draft_eng, ff_eng, off_eng, off_spec


def parity_engines():
    """The parity gate's engines (phase 19): the JAX tools' random fill of
    the 0.6B preset (``tools/quality_report._random_engine_inputs``, bit for
    bit the fixtures' weights) on the card and its byte-level tokenizer, at
    int8 units (the main path) and at bf16 units (the CLI's and the server's
    default), keyed by fixture name."""
    cfg, params = quality_report._random_engine_inputs(PARITY_PRESET, DEV)
    tok = quality_report._tiny_tokenizer()
    out = {}
    for name, quantize in PARITY_FIXTURES.items():
        out[name] = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize=quantize)
        if not out[name].is_ready():
            raise RuntimeError(f"parity engine {name}: {out[name].get_error()}")
    return out


def beside_build(tok, card_line, cfg=QWEN3_TTS_06B):
    """What needs no hand-written kernel, while the kernels build on a
    thread: the profiler's first start (its one-time set-up, ~10 s), the
    plain talker (``decode_impl="xla"``) with the cached and with the dense
    chain (B=1, B=4, a pool of 2, spec_k=4; nothing launched), and the
    meshes' plain routes (:func:`mesh_plain_runs`) and the data-parallel
    train step (:func:`mesh_train_step`); then what later phases take, which
    it returns: their engines (:func:`main_engines`, :func:`parity_engines`,
    :func:`shared_head_engine`) and phase 10's checkpoint
    (:func:`entry_checkpoint`).  The compilers hold the host's cores, so the
    plain engines' host-bound ms/frame and the checkpoint's save and load
    seconds are marked as taken beside the build."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    x = torch.ones((64,), device=DEV)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        float((x * 2).sum())
    params = init_params(cfg, seed=SEED, device=DEV, with_speaker_encoder=False)
    xla = dataclasses.replace(cfg.talker, decode_impl="xla")
    for impl in ("cached", "dense"):
        c = dataclasses.replace(cfg, talker=xla, code_predictor=dataclasses.replace(
            cfg.code_predictor, impl=impl))
        plain_engine_runs(c, params, tok, f"decode_impl=xla, impl={impl} (beside the build)",
                          card_line)
    mesh_plain_runs(cfg, params, tok, card_line)
    # the data-parallel train step on phase 17's batch (a generator of its
    # own, seeded as phase 17's, draws the same batch first)
    gen19 = torch.Generator(device=DEV)
    gen19.manual_seed(SEED + 19)
    mesh_train_step(cfg, params, train_batch(TRAIN_B, TRAIN_TEXT, TRAIN_FRAMES, gen19),
                    card_line)
    log(f"beside the build (profiler start, plain talker engines, mesh plain routes, "
        f"data-parallel train step): "
        f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    t0 = time.perf_counter()
    engines = main_engines(cfg, params, tok)
    del params
    gate_engines = parity_engines()
    shared_eng = shared_head_engine(tok, cfg)
    torch.cuda.synchronize()
    log(f"engines beside the build: 0.6B preset, random weights (seed {SEED}), int8, sequential, "
        f"spec_k={SPEC_K}, spec_k={SPEC_K} with a draft head, frame_fused, resident chain off "
        f"(sequential and spec_k={SPEC_K}); the parity gate's int8 and bf16 engines on the JAX "
        f"tools' fill; the shared-head engine through save and load: built in "
        f"{time.perf_counter() - t0:.1f} s; KV ladder {engines[0].kv_ladder} [{card_line}]")
    return engines, gate_engines, shared_eng, entry_checkpoint(card_line)


def shared_head_engine(tok, cfg=QWEN3_TTS_06B):
    """Phase 18's shared-head engine, beside the build (no kernel): a
    ``head_mode="shared"`` 0.6B checkpoint of the seed's weights saved and
    loaded back (int8)."""
    shared = dataclasses.replace(cfg, code_predictor=dataclasses.replace(
        cfg.code_predictor, head_mode="shared"))
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, shared, init_params(shared, seed=SEED, device=DEV,
                                                 with_speaker_encoder=False))
        eng = TTSEngine(tmp, tokenizer=tok, quantize="int8")
    if eng.cfg.code_predictor.head_mode != "shared" or "head" not in eng.params["code_predictor"]:
        raise RuntimeError("the shared-head checkpoint did not load its head")
    return eng


def routes_phase(tok, gen, card_line, shared_eng, cfg=QWEN3_TTS_06B):
    """Phase 18: the JAX package's routes outside its step and chain kernels
    at the 0.6B widths (the plain talker engines ran beside the build:
    ``beside_build``): K1 / K4 at the MTP trunk in the per-step chain, a
    shared-head checkpoint (saved and loaded) on the per-step chain and a
    pool of one slot on it, the iSTFT vocoder, K8 at the head_dims and
    groups the presets do not use (against its plain version and on the
    reach engine), and the plain attention's memory.  Returns (the shared
    engine's launch counts, K8 reach checks, the reach engine's launch
    counts, max abs err of the trunk steps)."""
    t0 = time.perf_counter()
    n = cfg.code_predictor.num_steps
    trunk_err, _ = trunk_step_checks(cfg, gen, card_line)
    eng = shared_eng
    reset_launches()
    r = eng.synthesize(FIXED_TEXT, temperature=0.0, max_tokens=PLAIN_FRAMES)
    if not np.isfinite(r.audio).all() or not r.metrics.decoded_frames:
        raise RuntimeError("shared-head engine: bad output")
    shared_counts = check_launches(f"shared-head 0.6B through save and load ({n} K1 per decoded "
                                   "frame: the per-step chain)",
                                   counts_of(K1=n * r.metrics.decoded_frames))
    # a pool of one slot: the talker step is K4 at one row (K1's arithmetic),
    # the per-step chain at B=1 K1 per chain position
    reset_launches()
    pool = ContinuousBatcher(eng, pool_size=1, chunk_len=4, kv_bucket=eng.kv_ladder[0])
    try:
        one = pool.submit(FIXED_TEXT, temperature=0.0, max_tokens=PLAIN_FRAMES).result(timeout=600)
    finally:
        pool.shutdown()
    got = launches()
    k1, k4 = got[KERNEL_IDS.index("K1")], got[KERNEL_IDS.index("K4")]
    if (not np.isfinite(one.audio).all() or not len(one.codes) or not k4 or k1 % (n - 1)
            or got != counts_of(K1=k1, K4=k4)):
        raise RuntimeError(f"a pool of one slot: launches {got}")
    log(f"a pool of one slot (shared head): {len(one.codes)} frames, K4 {k4} talker steps, K1 "
        f"{k1} chain steps; greedy codes equal to B=1 synthesize: "
        f"{np.array_equal(one.codes, r.codes[:len(one.codes)])} (data) [{card_line}]")
    del eng
    torch.cuda.empty_cache()
    istft_checks(cfg, gen, card_line)
    k8 = [check_k8("reach", B, S, T, nq, nk, kind, gen, iters=10, d=d)
          for B, S, T, nq, nk, d, kind in K8_REACH_CASES]
    reach = reach_engine_run(reach_engine(cfg, tok), card_line)
    plain_attention_memory(card_line)
    torch.cuda.empty_cache()
    log(f"routes phase: {time.perf_counter() - t0:.1f} s [{card_line}]")
    return shared_counts, k8, reach, trunk_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    started = time.perf_counter()
    global CARD
    CARD = card_line = card()
    log(f"card: {card_line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a packed talker's step that falls to the plain layers raises (the JAX
    # package's loud-failure switch): no route of the preset phases moves
    # off its kernel unseen; the routes phase's plain talkers are unpacked
    os.environ["QTTS_ASSERT_FUSED"] = "1"
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    with tempfile.TemporaryDirectory() as workdir:
        tok = byte_level_tokenizer(workdir)

    # the build on a thread, what needs no kernel beside it on this one (the
    # profiler's set-up must run on the thread that profiles later);
    # load_kernels builds under its lock, so a kernel wanted beside the
    # build would wait for it, not start a second one
    built = {}

    def build_run():
        t = time.perf_counter()
        try:
            count_entries(_build.load_kernels())
        except BaseException as e:  # raised again on this thread
            built["error"] = e
        built["s"] = time.perf_counter() - t

    builder = threading.Thread(target=build_run, daemon=True)
    builder.start()
    engines, gate_engines, shared_eng, checkpoint = beside_build(tok, card_line)
    builder.join()
    if "error" in built:
        raise built["error"]
    after_build = time.perf_counter()
    path = _build.library_path()
    log(f"build: {built['s']:.1f} s -> {os.path.basename(path)} [{CARD}]")
    objs = sorted(_build.object_times(path + ".log"), key=lambda o: -o[2])
    log("build by object (finished at s, compilers' CPU s): "
        + ", ".join(f"{o} {f:.0f} / {c:.0f}" for o, f, c in objs)
        + f"; {sum(c for *_, c in objs):.0f} s of CPU in all, {os.cpu_count()} CPUs [{CARD}]")
    with open(path + ".log") as f:
        fn = ""
        for line in f:
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            if "registers" in line or "spill" in line:
                spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
                log("  ptxas: " + line.strip() + (f" ({fn})" if spills else ""))

    cfg = QWEN3_TTS_06B
    talker_t = cfg.talker.transformer
    mtp_t = cfg.code_predictor.transformer
    talker_fw = packed_trunk(talker_t, gen)
    mtp_fw = packed_trunk(mtp_t, gen)
    k1 = [
        check_k1_deep("talker", talker_t, talker_fw, 256, 200, gen, 20),
        check_k1_deep("talker", talker_t, talker_fw, 2560, 1800, gen, 20),
        check_k1_deep("mtp-trunk", mtp_t, mtp_fw, 17, 9, gen, 50),
    ]
    check_k1_equal("0.6B talker", talker_t, talker_fw, K1_EQUAL_CASES, gen)
    check_k1_equal("0.6B MTP trunk", mtp_t, mtp_fw, ((17, 0), (17, 9), (17, 16)), gen)
    x, kc, vc = k1_inputs(talker_t, 256, 200, torch.bfloat16, gen)
    in_turns("K1 0.6B talker T=256 pos 200",
             lambda: k1_multi(talker_t, talker_fw, x, 200, kc, vc),
             lambda: K1.fused_decode_step(talker_t, talker_fw, x, 200, kc, vc), 20)
    trace_phases("K1 0.6B talker T=256 pos 200", K1._step_entry(talker_t, talker_fw, 256,
                                                                 x.device).plan,
                 step_phase_names(talker_t.num_layers),
                 lambda: K1.fused_decode_step(talker_t, talker_fw, x, 200, kc, vc))
    del x, kc, vc
    k4 = [
        check_k4_deep("talker", talker_t, talker_fw, 8, 512, gen, 10),
        check_k4_deep("talker", talker_t, talker_fw, 32, 512, gen, 5),
        check_k4_deep("mtp-trunk", mtp_t, mtp_fw, 8, 17, gen, 20),
    ]
    # the persistent K4 / K5 checks draw from a generator of their own, so
    # that every other check keeps the inputs it had without them
    gen45 = torch.Generator(device=DEV)
    gen45.manual_seed(SEED + 45)
    check_k4_equal("0.6B talker", talker_t, talker_fw, K4_EQUAL_CASES, gen45)
    macs = sum(w.numel() for w in (talker_fw.wqkv, talker_fw.wo, talker_fw.wgu, talker_fw.wd))
    log(f"K4 0.6B talker CUDA-core FMA floor at B=32: {fma_floor_ms(macs, 32):.4f} ms "
        f"({32 * macs / 1e9:.2f} G multiply-adds at {FP32_FMA_PER_S / 1e12:.1f} T/s) [{CARD}]")
    for B in (8, 32):
        x, kc, vc, pos = k4_inputs(talker_t, B, 512, torch.bfloat16, gen45)
        pos_dev = torch.tensor(pos, device=DEV)
        in_turns(f"K4 0.6B talker B={B} T=512",
                 lambda: k4_multi(talker_t, talker_fw, x, pos_dev, kc, vc),
                 lambda: K1.fused_decode_step_batched(talker_t, talker_fw, x, pos_dev, kc, vc), 10)
        trace_phases(f"K4 0.6B talker B={B} T=512",
                     K1._batch_entry(talker_t, talker_fw, B, 512, x.device).plan,
                     step_phase_names(talker_t.num_layers, batched=True),
                     lambda: K1.fused_decode_step_batched(talker_t, talker_fw, x, pos_dev, kc, vc))
        del x, kc, vc
    bounds = {
        "K1": step_bound(talker_t, talker_fw, 1, [200], 1, torch.bfloat16),
        "K4": step_bound(talker_t, talker_fw, 8, [min(p, 511) for p in K4_POSITIONS], 1,
                         torch.bfloat16),
    }
    k6 = [check_k6_deep("talker", talker_t, talker_fw, B, S, T, starts, gen, iters)
          for B, S, T, starts, iters in K6_DEEP_CASES]
    # the persistent K6 checks draw from a generator of their own, as K4's
    gen6 = torch.Generator(device=DEV)
    gen6.manual_seed(SEED + 6)
    check_k6_equal("0.6B talker", talker_t, talker_fw, [c[:4] for c in K6_DEEP_CASES], gen6)
    check_k6_equal("0.6B talker", talker_t, talker_fw, K6_STALL_CASES, gen6,
                   stall_ns=K6_STALL_NS)
    x, kc, vc, starts = k6_inputs(talker_t, 1, 4, 256, [200], torch.bfloat16, gen6)
    in_turns("K6 0.6B talker B=1 S=4 T=256 start 200",
             lambda: k6_multi(talker_t, talker_fw, x, starts, kc, vc),
             lambda: K6.fused_verify_step(talker_t, talker_fw, x, starts, kc, vc), 20)
    trace_phases("K6 0.6B talker B=1 S=4 T=256 start 200",
                 K6._verify_entry(talker_t, talker_fw, 1, 4, 256, torch.bfloat16, x.device).plan,
                 verify_phase_names(talker_t.num_layers),
                 lambda: K6.fused_verify_step(talker_t, talker_fw, x, starts, kc, vc))
    del x, kc, vc, talker_fw
    ts = dataclasses.replace(talker_t, num_layers=K1_SHALLOW_LAYERS)
    fws = packed_trunk(ts, gen)
    for cache_dtype in (torch.float32, torch.bfloat16):
        for T, pos in K1_SHALLOW_CASES:
            timed = cache_dtype == torch.float32 and pos == 1800
            k1.append(check_k1_shallow(f"talker-{K1_SHALLOW_LAYERS}-layer", ts, fws, T, pos,
                                       cache_dtype, gen, 20 if timed else 0))
        for B in K4_SHALLOW_BATCHES:
            k4_shallow = check_k4_shallow(ts, fws, B, 512, cache_dtype, gen)
            k4[0] = (max(k4[0][0], k4_shallow),) + k4[0][1:]
        for B, S, starts in K6_SHALLOW_CASES:
            k6_shallow = check_k6_shallow(ts, fws, B, S, 512, starts, cache_dtype, gen)
            k6[0] = (max(k6[0][0], k6_shallow),) + k6[0][1:]
    # a ring-wait fault shows only with one ring slot (see below)
    one_slot_ring(lambda: check_k6_equal(
        "talker-1-layer, one ring slot", ts, fws,
        [(B, S, 512, starts) for B, S, starts in K6_SHALLOW_CASES], gen6))
    del fws

    cp = cfg.code_predictor
    H, V, n = mtp_t.hidden_size, cp.subcode_vocab_size, cp.num_steps
    heads = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)))
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    # greedy and the engine's default knobs (timed), then top-k / top-p off
    # and top_k = 1
    k2 = [check_chain("K2", K2.fused_mtp_chain, K2.fused_mtp_chain_reference, knobs, cp, mtp_fw,
                      heads, tables, fnorm, gen, iters, cache_dtype=torch.bfloat16)
          for knobs, iters in (
        ((0.0,), 10), ((0.8, 50, 0.95), 10), ((1.0, 0, 1.0), 0), ((0.7, 1, 0.9), 0))]
    check_k2_equal("0.6B MTP trunk", cp, mtp_fw, heads, tables, fnorm, gen)
    lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    chain_args = (mtp_t, mtp_fw, fnorm, heads, tables, lh, c0, gumbel_noise((n, 1, V), gen, DEV),
                  *K5_KNOBS[1])
    in_turns(f"K2 0.6B sampled {K5_KNOBS[1]} bf16 cache",
             lambda: k2_multi(*chain_args, cache_dtype=torch.bfloat16),
             lambda: K2.fused_mtp_chain(*chain_args, cache_dtype=torch.bfloat16), 10)
    trace_phases(f"K2 0.6B sampled {K5_KNOBS[1]}",
                 K2._chain_entry("qtts_mtp_chain", mtp_t, mtp_fw, heads, tables,
                                 torch.bfloat16, lh.device).plan,
                 chain_phase_names(mtp_t.num_layers, n),
                 lambda: K2.fused_mtp_chain(*chain_args, cache_dtype=torch.bfloat16))
    del chain_args
    # a ring-wait fault shows only where a stage's copy is issued just before
    # it is read: every persistent plan at one slot
    one_slot_ring(lambda: (
        check_k1_equal("0.6B MTP trunk, one ring slot", mtp_t, mtp_fw, ((17, 16),), gen, inputs=1),
        check_k2_equal("0.6B MTP trunk, one ring slot", cp, mtp_fw, heads, tables, fnorm, gen,
                       inputs=1),
        check_k4_equal("0.6B MTP trunk, one ring slot", mtp_t, mtp_fw, ((5, 17), (32, 17)),
                       gen45),
        check_k5_equal("0.6B MTP trunk, one ring slot", cp, mtp_fw, heads, tables, fnorm, gen45,
                       batches=(8, 32), cache_dtypes=(torch.bfloat16,))))
    # B=8 and 32 (the batched paths), and 4 rows (a B=1 verify iteration at k=4)
    # against the plain chain at 8, 16 and 4 rows (a plain chain of 32 rows
    # takes ~9 s); at 32 rows bit for bit against K2 (check_k5_equal)
    k5 = [check_k5(B, cp, mtp_fw, heads, tables, fnorm, gen, iters)
          for B, iters in ((8, 5), (16, 3), (4, 5))]
    check_k5_equal("0.6B MTP trunk", cp, mtp_fw, heads, tables, fnorm, gen45)
    macs = (n + 1) * sum(w.numel() for w in (mtp_fw.wqkv, mtp_fw.wo, mtp_fw.wgu, mtp_fw.wd)) + (
        heads.q.numel())
    log(f"K5 0.6B chain CUDA-core FMA floor at B=32: {fma_floor_ms(macs, 32):.4f} ms "
        f"({32 * macs / 1e9:.2f} G multiply-adds: {n + 1} trunk passes and {n} heads) [{CARD}]")
    for B in (8, 32):
        knobs = [K5_KNOBS[b % len(K5_KNOBS)] for b in range(B)]
        lhb = (torch.randn((B, H), generator=gen45, device=DEV) * 0.5).to(torch.bfloat16)
        c0b = (torch.randn((B, H), generator=gen45, device=DEV) * 0.02).to(torch.bfloat16)
        batch_args = (mtp_t, mtp_fw, fnorm, heads, tables, lhb, c0b,
                      gumbel_noise((n, B, V), gen45, DEV), *zip(*knobs))
        in_turns(f"K5 0.6B B={B} mixed knobs {K5_KNOBS} bf16 cache",
                 lambda: k5_multi(*batch_args, cache_dtype=torch.bfloat16),
                 lambda: K2.fused_mtp_chain_batched(*batch_args, cache_dtype=torch.bfloat16), 5)
        trace_phases(f"K5 0.6B B={B} mixed knobs",
                     K2._batch_chain_entry("qtts_mtp_chain_batched", mtp_t, mtp_fw, heads, tables,
                                           B, torch.bfloat16, lhb.device).plan,
                     chain_phase_names(mtp_t.num_layers, n, batched=True),
                     lambda: K2.fused_mtp_chain_batched(*batch_args, cache_dtype=torch.bfloat16))
    del batch_args
    bounds["K2"] = chain_bound(mtp_t, mtp_fw, heads, 1)
    # K1 and K4 at the MTP trunk (the per-step chain): a step at slot 9 of
    # 17, and 8 rows at check_k4_deep's positions clamped into the 17 slots
    bounds["K1 MTP trunk"] = step_bound(mtp_t, mtp_fw, 1, [9], 1, torch.bfloat16)
    bounds["K4 MTP trunk"] = step_bound(mtp_t, mtp_fw, 8, [min(p, 16) for p in K4_POSITIONS],
                                        1, torch.bfloat16)
    bounds["K5"] = chain_bound(mtp_t, mtp_fw, heads, 8)
    del mtp_fw, heads, tables
    torch.cuda.empty_cache()
    k7, bounds["K7"], _ = frame_checks(cfg, gen)
    check_p1_ring(gen6)
    check_p2_ring(gen6)
    probed, p1, p2 = probe_phase()

    eng, spec_eng, draft_eng, ff_eng, off_eng, off_spec = engines

    reset_launches()
    requests = B1_REQUESTS
    decoded, ttfa = 0, []
    for req in requests:
        r = eng.synthesize(max_tokens=48, seed=SEED, **req)
        m = r.metrics
        decoded += m.decoded_frames
        ttfa.append(m.ttfa_seconds * 1e3)
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"bad synthesis output for {req}")
        decode_ms = m.stage_seconds.get("decode", 0.0) * 1e3 / max(m.decoded_frames, 1)
        log(f"synthesize {req['language']} T={req['temperature']}: {m.frames} frames "
            f"({m.decoded_frames} decoded), {decode_ms:.3f} ms/frame decode, RTF "
            f"{m.rtf:.2f}x, TTFA {m.ttfa_seconds * 1e3:.1f} ms, total "
            f"{m.total_seconds * 1e3:.1f} ms [{card_line}]")
    seq_ms = check_fixed_run(eng, FIXED_FRAMES, [FIXED_TEXT], card_line)
    figure("0.6B B=1 ms/frame", seq_ms)
    figure("0.6B B=1 TTFA ms (3 requests)", [round(x, 1) for x in ttfa])
    decoded += FIXED_FRAMES
    b1 = check_launches("B=1 slice (one K1 and one K2 per decoded frame)",
                        (decoded, decoded, 0, 0, 0))
    framed, _, _ = frame_fused_phase(eng, ff_eng, requests, card_line)
    del ff_eng
    batched, batched_ms = batched_phase(eng, card_line)
    batched_figures(batched_ms)
    pooled = pool_phase(eng, card_line)
    soaked = pool_soak(eng, card_line)
    spec, _ = spec_phase(eng, spec_eng, draft_eng, seq_ms, card_line)
    # past 32 rows: a batch of 40 (two launches of 20 rows a kernel), a pool
    # of 40 slots and a spec pool of 12 x 4 rows
    past32 = [sum(c) for c in zip(batch_rows_equal(eng, 40, "0.6B int8", card_line),
                                  pool_rows_equal(eng, spec_eng, card_line))]
    del eng, spec_eng, draft_eng
    off_counts, _ = resident_off_runs(off_eng, off_spec, card_line)
    del off_eng, off_spec
    torch.cuda.empty_cache()
    gated = tools_phase(gate_engines, card_line)
    entry, numbers = entry_phase(tok, card_line, checkpoint)
    voice, k1_17b, k3, k8, voice_bounds, off17 = voice_phase(tok, gen, card_line)
    k1 += k1_17b
    bounds.update(voice_bounds)
    # the bf16 units' phase draws from a generator of its own, as K4's
    gen16 = torch.Generator(device=DEV)
    gen16.manual_seed(SEED + 16)
    bf16, (k1b, k4b, k3b, k5b), bf16_bounds, (b17, b17_checks, b17_bounds) = bf16_phase(
        tok, gen16, card_line)
    bounds.update({f"{k} bf16": v for k, v in bf16_bounds.items()})
    bounds.update(b17_bounds)
    bf16 = [sum(c) for c in zip(bf16, numbers["bf16_counts"], gated["bf16"])]
    # the int8 KV cache's phase draws from a generator of its own, as K4's
    gen8 = torch.Generator(device=DEV)
    gen8.manual_seed(SEED + 8)
    kvq, (k1q, k4q, k6q, k7q), kvq_bounds = kvq_phase(tok, gen8, card_line)
    bounds.update(kvq_bounds)
    kvq = [sum(c) for c in zip(kvq, numbers["kvq_counts"])]
    unlaunched = [k for k in ("K1", "K4", "K6", "K7") if not kvq[KERNEL_IDS.index(k)]]
    if unlaunched:
        raise RuntimeError(f"the int8 KV cache's main paths never launched {unlaunched}")
    # the tensor-parallel phase draws from a generator of its own, as K4's
    gen9 = torch.Generator(device=DEV)
    gen9.manual_seed(SEED + 9)
    tp_counts, (k9, k10), tp_bounds = tp_phase(tok, gen9, card_line)
    bounds.update(tp_bounds)
    # the precision flags' phase draws from a generator of its own, as K4's
    gen15 = torch.Generator(device=DEV)
    gen15.manual_seed(SEED + 15)
    precision, pchecks, pbounds, cli_k7 = precision_phase(tok, gen15, card_line,
                                                          numbers["spec_counts"])
    bounds.update(pbounds)
    # K7 at every unit mix and the kernels past 32 rows draw from a generator
    # of their own, as K4's
    gen18 = torch.Generator(device=DEV)
    gen18.manual_seed(SEED + 18)
    mix_counts, mix_checks, mix_bounds = finish_phase(tok, gen18, card_line)
    bounds.update(mix_bounds)
    # the training slice draws from a generator of its own, as K4's
    gen19 = torch.Generator(device=DEV)
    gen19.manual_seed(SEED + 19)
    train, k8_teacher, train_bounds = train_phase(tok, gen19, card_line)
    bounds.update(train_bounds)
    # the routes outside the step and chain kernels draw from a generator of
    # their own, as K4's
    gen20 = torch.Generator(device=DEV)
    gen20.manual_seed(SEED + 20)
    del os.environ["QTTS_ASSERT_FUSED"]
    shared_counts, k8_reach, reach_counts, trunk_err = routes_phase(tok, gen20, card_line,
                                                                    shared_eng)
    bounds["K8 reach"] = k8_reach[0][4]
    per_step = [sum(c) for c in zip(off_counts, off17, shared_counts)]
    # its engines run bf16 units: K1, K3 and K5 join the bf16 rows, K6 the K6
    # bf16 row; its K8 launches are the teacher passes
    k8i = KERNEL_IDS.index("K8")
    bf16 = [b + (0 if i == k8i else n) for i, (b, n) in enumerate(zip(bf16, train))]
    precision["K6 bf16"] += train[KERNEL_IDS.index("K6")]
    k7i = KERNEL_IDS.index("K7")
    mixed = {k: c[k7i] + cli_k7.get(k, 0) for k, c in mix_counts.items()}
    total = [sum(c) for c in zip(b1, framed, batched, pooled, soaked, gated["int8"], spec, past32,
                                 entry, voice, probed, tp_counts, b17["1.7B int8"])]
    log("launches on the main paths in all, int8 units: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, total)) + "; bf16 units: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, bf16)) + "; int8 KV cache: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, kvq)) + "; precision flags: "
        + ", ".join(f"{k} {n}" for k, n in precision.items()) + "; K7 unit mixes: "
        + ", ".join(f"{k} {n}" for k, n in mixed.items()) + "; training: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, train)) + "; per-step chains: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, per_step)) + "; K8 reach engine: "
        + ", ".join(f"{k} {n}" for k, n in zip(KERNEL_IDS, reach_counts)))

    def entry(name, source, replaces, launched, checks, bound_key, library_ms=None):
        # library_ms: one PyTorch call computing the same function, where one
        # exists (none computes a fused step, chain, frame or probe chain)
        ms_bound, bound_by = bounds[bound_key]
        if not replaces.startswith("tools/"):
            replaces = f"leaxer_qwen3_tts_tpu/ops/{replaces}"
        return {"name": name, "route": "cuda", "source": f"leaxer_qwen3_tts_torch/csrc/{source}",
                "replaces": replaces, "launches": launched,
                "max_abs_err": max(c[0] for c in checks), "ms": checks[0][1],
                "plain_ms": checks[0][2], "bound_ms": ms_bound, "bound_by": bound_by,
                "library_ms": library_ms}

    bounds["K6"] = k6[0][3]
    # the probes: error over every arm; time, plain time and bound of the
    # convert arm (P1 conv, P2 bf16), one call of the whole chain
    for key, results in (("P1", p1), ("P2", p2)):
        bounds[key] = (results[0]["bound_ms"], results[0]["bound_by"])
    probe_checks = {key: [(max(r["err"] for r in results), results[0]["ms"],
                           results[0]["plain_ms"])] for key, results in (("P1", p1), ("P2", p2))}
    report = {"kernels": [
        entry("fused_decode_step", "fused_step.cu", "fused_step.py:1290", total[0], k1, "K1"),
        entry("fused_mtp_chain", "fused_mtp.cu", "fused_mtp.py:835", total[1], k2[1:] + k2[:1],
              "K2"),
        entry("fused_decode_step_batched", "fused_step_batched.cu", "fused_step.py:2083",
              total[2], k4, "K4"),
        entry("fused_mtp_chain_batched", "fused_mtp_batched.cu", "fused_mtp.py:703", total[3], k5,
              "K5"),
        entry("fused_verify_step", "fused_verify.cu", "fused_verify.py:473", total[4], k6, "K6"),
        entry("fused_mtp_chain_streamed", "fused_mtp_stream.cu", "fused_mtp_stream.py:372",
              total[5], k3, "K3"),
        entry("flash_attend", "flash_attention.cu", "flash_attention.py:81",
              total[6] + train[k8i], k8, "K8", library_ms=k8[0][3]),
        # the draft trainer's frozen teacher pass: B=8, S = T = prompt + 128
        # frames, padded frames masked as keys
        entry("flash_attend (K8 draft teacher)", "flash_attention.cu", "flash_attention.py:81",
              train[k8i], [k8_teacher], "K8 teacher", library_ms=k8_teacher[3]),
        entry("fused_frame_step", "fused_frame.cu", "fused_frame.py:245", total[7], k7, "K7"),
        entry("a8_probe", "unit_probe.cu", "tools/a8_probe.py:93", total[8], probe_checks["P1"],
              "P1"),
        entry("w8a8_probe", "unit_probe.cu", "tools/w8a8_probe.py:33", total[9],
              probe_checks["P2"], "P2"),
        # bf16 weight units (quantize unset): the same kernels' bits=16 instances
        entry("fused_decode_step (bf16 units)", "fused_step.cu", "fused_step.py:1290", bf16[0],
              k1b, "K1 bf16"),
        entry("fused_decode_step_batched (bf16 units)", "fused_step_batched.cu",
              "fused_step.py:2083", bf16[2], k4b, "K4 bf16"),
        entry("fused_mtp_chain_batched (bf16 units)", "fused_mtp_batched.cu", "fused_mtp.py:703",
              bf16[3], k5b, "K5 bf16"),
        entry("fused_mtp_chain_streamed (bf16 units)", "fused_mtp_stream.cu",
              "fused_mtp_stream.py:372", bf16[5], k3b, "K3 bf16"),
        # the int8 KV cache (kv_quant): the same kernels' int8-cache instances
        entry("fused_decode_step (K1 kvq: int8 KV cache)", "fused_step.cu", "fused_step.py:1290",
              kvq[0], k1q, "K1 kvq"),
        entry("fused_decode_step_batched (K4 kvq: int8 KV cache)", "fused_step_batched.cu",
              "fused_step.py:2083", kvq[2], k4q, "K4 kvq"),
        entry("fused_verify_step (K6 kvq: int8 KV cache)", "fused_verify.cu", "fused_verify.py:473",
              kvq[4], k6q, "K6 kvq"),
        entry("fused_frame_step (K7 kvq: int8 KV cache)", "fused_frame.cu", "fused_frame.py:245",
              kvq[7], k7q, "K7 kvq"),
        # the tensor-parallel path on a mesh listing the card twice (0.6B,
        # timed) or four times (1.7B): per step (one launch for the card's
        # ranks) and per chain
        entry("fused_decode_step_tp (K9)", "fused_tp.cu", "fused_tp.py:573", total[10], k9, "K9"),
        entry("fused_mtp_chain_tp (K10)", "fused_mtp_tp.cu", "fused_mtp_tp.py:364", total[11],
              k10[1:2] + k10, "K10"),
        # the CLI's remaining precision flags: int4 units (--quantize int4),
        # heads of another type than the trunk (--mtp-quantize), bf16 units
        # in K6 (--spec-k at an unset --quantize)
        entry("fused_decode_step (K1 int4 units)", "fused_int4.cu", "fused_step.py:1290",
              precision["K1 int4"], pchecks["K1 int4"], "K1 int4"),
        entry("fused_decode_step (K1 int4 units, int8 KV cache)", "fused_int4.cu",
              "fused_step.py:1290", precision["K1 int4 kvq"], [pchecks["K1 int4 kvq"]],
              "K1 int4"),
        entry("fused_mtp_chain (K2 int4 trunk, int8 heads)", "fused_int4.cu", "fused_mtp.py:835",
              precision["K2 int4"], pchecks["K2 int4"], "K2 int4"),
        entry("fused_mtp_chain (K2 int8 trunk, bf16 heads)", "fused_mtp.cu", "fused_mtp.py:835",
              precision["K2 int8 trunk, bf16 heads"], pchecks["K2 int8 trunk, bf16 heads"],
              "K2 int8 trunk, bf16 heads"),
        entry("fused_mtp_chain (K2 int4 trunk, bf16 heads)", "fused_int4.cu", "fused_mtp.py:835",
              precision["K2 int4 trunk, bf16 heads"], pchecks["K2 int4 trunk, bf16 heads"],
              "K2 int4 trunk, bf16 heads"),
        entry("fused_mtp_chain_streamed (K3 int4 trunk, int8 heads)", "fused_int4.cu",
              "fused_mtp_stream.py:372", precision["K3 int4"], pchecks["K3 int4"], "K3 int4"),
        entry("fused_mtp_chain_streamed (K3 int8 trunk, bf16 heads)", "fused_mtp.cu",
              "fused_mtp_stream.py:372", precision["K3 int8 trunk, bf16 heads"],
              pchecks["K3 int8 trunk, bf16 heads"], "K3 int8 trunk, bf16 heads"),
        entry("fused_verify_step (K6 bf16 units)", "fused_verify.cu", "fused_verify.py:473",
              precision["K6 bf16"], pchecks["K6 bf16"], "K6 bf16"),
        entry("fused_verify_step (K6 bf16 units, int8 KV cache)", "fused_verify.cu",
              "fused_verify.py:473", precision["K6 bf16 kvq"], [pchecks["K6 bf16 kvq"]],
              "K6 bf16"),
        # every weight precision in the batched kernels: int4 units in K4, K5
        # and K6, heads of another type than the trunk and the auto alt trunk
        # in K5, and bf16 units at the 1.7B widths (the 48 KB batched plans)
        entry("fused_decode_step_batched (K4 int4 units)", "fused_int4.cu", "fused_step.py:2083",
              precision["K4 int4"], pchecks["K4 int4"], "K4 int4"),
        entry("fused_mtp_chain_batched (K5 int4 trunk, int8 heads)", "fused_int4.cu",
              "fused_mtp.py:703", precision["K5 int4"], pchecks["K5 int4"], "K5 int4"),
        entry("fused_mtp_chain_batched (K5 int8 trunk, bf16 heads)", "fused_mtp_batched.cu",
              "fused_mtp.py:703", precision["K5 int8 trunk, bf16 heads"],
              pchecks["K5 int8 trunk, bf16 heads"], "K5 int8 trunk, bf16 heads"),
        entry("fused_mtp_chain_batched (K5 int4 trunk, bf16 heads)", "fused_int4.cu",
              "fused_mtp.py:703", precision["K5 int4 trunk, bf16 heads"],
              pchecks["K5 int4 trunk, bf16 heads"], "K5 int4 trunk, bf16 heads"),
        entry("fused_verify_step (K6 int4 units)", "fused_int4.cu", "fused_verify.py:473",
              precision["K6 int4"], pchecks["K6 int4"], "K6 int4"),
        entry("fused_verify_step (K6 int4 units, int8 KV cache)", "fused_int4.cu",
              "fused_verify.py:473", precision["K6 int4 kvq"], [pchecks["K6 int4 kvq"]],
              "K6 int4"),
        entry("fused_decode_step_batched (K4 bf16 units, 1.7B)", "fused_step_batched.cu",
              "fused_step.py:2083", b17["K4 bf16 1.7B"][KERNEL_IDS.index("K4")],
              b17_checks["K4 bf16 1.7B"], "K4 bf16 1.7B"),
        entry("fused_mtp_chain_batched (K5 bf16 units, 1.7B)", "fused_mtp_batched.cu",
              "fused_mtp.py:703", b17["K4 bf16 1.7B"][KERNEL_IDS.index("K5")]
              + b17["K6 bf16 1.7B"][KERNEL_IDS.index("K5")], b17_checks["K5 bf16 1.7B"],
              "K5 bf16 1.7B"),
        entry("fused_verify_step (K6 bf16 units, 1.7B)", "fused_verify.cu", "fused_verify.py:473",
              b17["K6 bf16 1.7B"][KERNEL_IDS.index("K6")], b17_checks["K6 bf16 1.7B"],
              "K6 bf16 1.7B"),
        # K7 at every unit mix the engine builds (int4 units, a bf16 talker
        # beside an int8 or int4 trunk), on a bf16 and an int8 talker cache
        # the per-step chain (the resident chain off, QTTS_MTP_STREAM=0 at
        # 1.7B, the shared head): K1 and K4 at the MTP trunk, once per chain
        # position; errors from the chain's every step against the plain
        # version, times from the trunk-shape checks of phase 3
        entry("fused_decode_step (K1 at the MTP trunk: the per-step chain)", "fused_step.cu",
              "fused_step.py:1290", per_step[0], [(max(trunk_err, k1[2][0]),) + k1[2][1:]],
              "K1 MTP trunk"),
        entry("fused_decode_step_batched (K4 at the MTP trunk: the per-step chain)",
              "fused_step_batched.cu", "fused_step.py:2083", per_step[2],
              [(max(trunk_err, k4[2][0]),) + k4[2][1:]], "K4 MTP trunk"),
        # K8 at the head_dims and q-per-kv groups the presets do not use, on a
        # talker of head_dim 80 and 32 q heads per kv head
        entry("flash_attend (K8 reach: head_dim 17-256, 1-32 q heads per kv head)",
              "flash_attention.cu", "flash_attention.py:81", reach_counts[k8i], k8_reach,
              "K8 reach", library_ms=k8_reach[0][3]),
        *[entry(f"fused_frame_step ({key}{', int8 KV cache' if kv else ''})",
                "fused_frame.cu" if K7_MIXES[key][:2] == ("bf16", "int8") else "fused_int4.cu",
                "fused_frame.py:245", mixed[key + kv], mix_checks[key + kv], key + kv)
          for key in K7_MIXES for kv in ("", " kvq")],
    ]}
    unlaunched = [k["name"] for k in report["kernels"] if not k["launches"]]
    if unlaunched:
        raise RuntimeError(f"kernels never launched on their main paths: {unlaunched}")
    after = time.perf_counter() - after_build
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all: the build {built['s']:.1f} s, "
        f"after it {after:.1f} s; on the slowest host seen (a 588.8 s build, every phase 1.235x "
        f"longer) that would be {588.8 + 1.235 * after:.1f} s [{card_line}]")
    print(json.dumps(report))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
