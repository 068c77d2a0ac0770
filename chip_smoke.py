#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port ``esme_tpu_torch`` on one CUDA card,
or with ``--ranks 4`` on four.

    python3 chip_smoke.py [--profile DIR] [--sizes NAME,...]
    python3 chip_smoke.py --ranks 4 [--profile DIR]

Phases, in order; any failure exits non-zero before a result is printed.
With ``--sizes`` (names of ``SIZE_RUNS``, e.g. ``esm2_8m,esm2_35m``) only
phases 1, 2 and 12 run, on those sizes and their head dims, and the last
line is phase 12's JSON. With ``--ranks N`` (N in ``RANK_CHOICES``; it
fails unless the machine has N cards) phases 1 (every card's line), 2 and
20 run, and the last three lines are phase 20's kernels, its measurements
and the contract's line:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``esme_tpu_torch/csrc`` with ``nvcc`` (timed);
   H1's and H2's mma.sync mode-0 instantiations (``flash_fwd.cu``,
   ``flash_bwd.cu``) must keep the registers, stack and spills ``ptxas``
   gave them before the ablation modes, H1's and H2's Hopper production
   kernels (``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu`` at D = 32, 64,
   128) the ones they had before the token-minor layout and the Hopper
   ablation modes (``SM90_PRODUCTION``), and at D = 16, 24 (32-column
   tiles) no stack frame and no spills, H5's Hopper form at D = 64 and
   every H6 mode of H1's Hopper form no stack frame and no spills (but
   ``noqk``'s pinned ``H6_SPILLS``; no ``wgmma`` serialisation warning
   names an H6 mode), every H7 mode of
   both Hopper passes must build (every instantiation's ``ptxas`` line
   and any ``wgmma`` serialisation warning is logged), and H8's Hopper
   kernels (``probes_sm90.cu``: dma alone and in pairs, dma_t) must have
   no stack frame and no spills; H9's instantiations (the rectangular
   forward, ``flash_fwd_rect_sm90_kernel`` at D = 16-128 and
   ``flash_fwd_rect_kernel`` at every padded width) logged, with no more
   stack and spills than H1's production kernel of the same form and width
   (none); H10's (the rectangular backward: ``bwd_dkv_rect_sm90_kernel``
   and ``bwd_dq_rect_sm90_kernel`` at D = 16-128, ``flash_bwd_dkv_rect_kernel`` and
   ``flash_bwd_dq_rect_kernel`` at every padded width) logged, with no
   more stack and spills than H2's production pass of the same form and
   width (its Hopper dk/dv pass spills at D = 128);
3. hold each kernel against its plain PyTorch version on the card, on a
   packed 8k-token batch: segment-flash forward (H1) and backward (H2),
   each on its route (``fwd_route``, ``bwd_route``: the Hopper form at
   every head dim) and at 16 and 24 on the other form too, at head dims
   16, 24, 32, 64 and 128, each bit-equal across two calls; both also on
   8k tokens of one segment (every tile
   unmasked), of 1-70-token segments and of interleaved ids (every tile
   masked), H1 also at a ragged T (T % 64 != 0); RoPE (H3) forward and
   inverse,
   the head relayout (H4) in every layout pair and rotation the ops use
   at each head dim (bit-equal) at T % 8 == 0 and != 0, on the kernel
   its rule picks (``relayout_route``, shown by its counter: rows, vec or
   tile) and at T % 8 == 0 on the tile kernel too, each beside its gate;
   H9, the rectangular forward (``segment_flash_fwd(..., seg_k=)``), on
   every rank r of n = 2, 4 and 8 ranks of the check batch (rows
   [r·T/n, (r+1)·T/n) over all T keys) at D = 16, 24, 32, 64, 128, on its
   route and, where that is the Hopper form, on the mma.sync form's
   rectangular entry too, under H1's gates and bit-equal across two calls;
   where the rank's first row starts a q block (every split of the check
   batch), H9's o and lse bit-equal to H1's rows on the whole batch; a
   ragged split (Tq % 128 != 0); a q block whose ids match no key written
   as o = 0, lse = ``EMPTY_LSE`` on both forms; H10, the rectangular
   backward (``segment_flash_bwd(..., seg_k=)``), on one rank and every
   rank of 2, 4 and 8 ranks of the check batch at D = 16, 24, 32, 64, 128
   on its route and, where that is the Hopper form, on the mma.sync form's
   rectangular entry too, under H2's gate (dk and dv on the key rows the
   rank's queries touch, exactly 0 on the rest) and bit-equal across two
   calls; on each form, dq bit-equal to that form's H2 rows where the
   rank's first row starts a q block, every output bit-equal to H2 with
   one rank, and dk, dv summed over the ranks under H2's gate against H2;
   a ragged split; a q block whose ids match no key (dq = 0) and key
   blocks no query touches (dk = dv = 0);
4. the inference path: ESM2-650M (33 layers, width 1280, 20 heads,
   bf16, weights from seed 0) ``predict_log_prob(tokens,
   pad_args=(cu_lens, max_len))`` on ``bench.py``'s packed batch (seed
   0, 100-1000 aa, 50,000-token budget), with every launch counter set
   to 0 just before and read just after; then, on a smaller batch at
   full depth, the port with kernels (launches exact) against the port
   with plain versions and against its einsum attention path; its time
   (CUDA events after warm-up, peak memory);
5. the training path: ``MaskedPLM(model, learning_rate=1e-4)
   .training_step(batch)`` on ``bench.py``'s masked-LM batch recipe
   (lengths and tokens seed 2, masking seed 1, no loss on the tail), at
   a 10,000-token budget without checkpointing (one warm-up step, 5
   timed) and at 50,000 with ``checkpointing=True, remat='full'`` (one
   warm-up, 3 timed), with the launch counters read around the warm-up
   step; losses finite and falling; then, at full depth on a 4k batch,
   every leaf's gradient with kernels against with plain versions, and
   with ``remat='full'`` against without; then a two-step ``fit`` over a
   ``MaskedFastaTokenDataset`` on a FASTA file written from seed 0;
6. the attention op API at the main shape (T = 50,176, H = 20, D = 64,
   bf16), each op with the launch counters set to 0 just before and
   read just after, against the same op through the plain versions:
   ``flash_segment_attention`` ('thd' and 'htd') and ``flash_tm``,
   forward and backward, under H1's and H2's gates; ``split_heads_rotary``
   -> ``merge_heads``, values and gradients, bit-equal (and the merged q
   and k bit-equal to H3's); ``fwd_v2`` against ``segment_flash_fwd``;
   JAX's ``ESME_FLASH_IMPL=v2`` steps, ``_split_call_t`` -> ``fwd_v2``
   -> ``_merge_call``, against ``fused_rotary_flash``'s forward (o under
   H1's gate, lse within 1e-4). A plain run in which a kernel's counter
   moves fails (phases 4 and 5 too);
7. times: each kernel at its path's shapes beside its bound, its plain
   version and library calls timed as yardsticks only (the port calls
   none): for H1 ``scaled_dot_product_attention`` with a dense
   block-diagonal mask (``library_ms``, T^2 work) and PyTorch's varlen
   flash-attention forward over the same segments
   (``library_varlen_ms``; its ratio is logged, not gated) and its
   mma.sync form through its C entry (H1 on its route, the Hopper form at
   D = 64, must be faster); for H2 PyTorch's varlen flash-attention
   backward (``library_ms``), each of its passes alone and its mma.sync
   form; H1's Hopper form and each of H2's passes on T tokens of one
   segment against the same batch with one token of each 64-token tile
   given its own id (every tile unmasked, then every tile masked: each
   must be faster on the first, where the mask is skipped); the counts of
   (16-row, 64-row tile) units that lie in one segment, worked out from
   the segment ids by H2's rule (``mask_units``: the train batch's, and
   the inference batch's over H1's spans), are logged with the
   measurements as properties of the batches; for H4,
   each of its modes at the main shape on its route, with one
   ``permute(...).contiguous()`` call as the yardstick of a move without
   rotation, and each move with an hdt side (the vec kernel at this T)
   also on the tile kernel, held bit-equal to the plain version there
   too and timed in turn with the vec kernel (fastest of 8 calls each,
   on the card alone): the vec kernel faster where the move rotates, and
   within 3% of the tile kernel where it does not. ``--profile DIR`` also writes
   ``torch.profiler`` tables of one forward and one train step there (and
   of phase 9's models' cells under ``DIR/<model>/``);
8. the probe tools' kernels (``esme_tpu_torch/tools``, none on the model
   path, where their counters must stay 0): on the 8k check batch, H5 on
   its route (``fwd_T_route``: H1's Hopper kernel on token-minor operands
   at head dims 32-128, the mma.sync form with transposed scores at 16, 24
   and at a T that is not a multiple of 8, the route counter showing which
   ran) under H1's gates, every ablation mode of both forms of H1 (H6, 11
   modes each) and of
   both passes of both forms of H2 (H7, 8 modes each; the Hopper form's
   dk/dv pass over the union spans it walks) and the four ceiling probes
   (H8; the streaming ones, dma and dma_t, in both forms, the Hopper form
   ``probes_sm90.cu`` and the cp.async form ``probes.cu``, and dma also in
   2-CTA pairs), each against its plain version under the gate its tool's
   ``check`` states (H6 on both forms against the plain version of the
   form's walk, the Hopper form's ``baseline`` bit-equal to H1; H8's
   Hopper forms and pairs bit-equal to the cp.async form); then each
   tool's own run at the main shapes (H5 beside
   H1, every mode and probe timed beside the bound of the work it keeps,
   H6 and H8 on the inference batch, H7 on the 50k train batch), with the
   launch counters set to 0 just before and read just after; H5's Hopper
   form bit-equal to H1's (on the 8k batch too) and faster than its
   mma.sync form (fastest of 8 calls each, timed on the card alone), which
   is held under H1's gates against the plain version and H1 there, beside
   the varlen library and the bound; every H6 mode of both forms timed,
   the Hopper form's ``baseline`` bit-equal to H1 there, the mma.sync
   form's to H1's mma.sync form, and H1's Hopper form under H1's gates
   against the latter;
   H7 ``real`` of the Hopper form bit-equal to H2 and within 3% of H2's
   own passes timed in turn with it (fastest of 8 calls each, timed on the
   card alone; a gate on ``REF_CARD``), of the mma.sync form bit-equal to
   that form and under H2's gate against the Hopper form; the mma.sync forms' times (H1's and
   H6 ``baseline``, H2's and H7 ``real``) within 3% of their times before
   the ablation modes were added, on the card those were taken on
   (``REF_CARD``; logged on any other); H2's Hopper form faster than its
   mma.sync form, its time logged beside it and the library's; H8's
   Hopper forms and pairs bit-equal to the cp.async form there too, and
   each Hopper form faster than its cp.async form (fastest of 8 calls each,
   on the card alone; the pairs are timed beside them, not gated);
9. the other families: H1, H2 and H3 at ESMC's head counts (15 and 18,
   D = 64) against their plain versions on the 8k check batch; with 15
   heads at the main shapes, timed beside their bounds, plain versions
   and varlen library calls; H1 and H3 with 18 heads against their plain
   versions at the main inference shape; then ESMC-300M (30 layers, width
   960, 15 heads), ESM1b (33, 1280, 20), ESMC-600M (36, 1152, 18) and
   ESM1v, at full width and depth, with seeded random weights written
   through the safetensors schema and loaded with ``ESM.from_pretrained``
   (every leaf bit-equal): ESMC-300M, ESM1b and ESMC-600M through phase
   4's inference cell on the main batch (launches exact: H1 once per
   layer, H3 once per layer in ESMC and never in ESM1b), all four through
   phase 4's comparisons on the 4k batch (ahead of the timed forwards, as
   in phase 4), ESMC-300M and ESM1b through phase 5's ``nockpt@10k`` cell
   and gradient checks (H3 and its inverse 0 times in ESM1b), and a
   4,095-residue ESM1b sequence refused with ``ValueError`` before any
   launch on both entry routes;
10. context parallelism: a one-rank NCCL world on 127.0.0.1 and its
   ``seq`` ``DeviceMesh`` on the card; ESM2 at phase 4's size and weights
   through ``context_parallel_log_prob`` on the main batch, with every
   launch counter set to 0 just before and read just after (H9 and H3 once
   per layer, H1 and H2 never), its log-probs finite normalised rows held
   against the same model's ``predict_log_prob`` under phase 4's gate and
   bit-equal to them (one rank), its time (CUDA events after a warm-up),
   real tokens/s and peak memory beside phase 4's; the process group
   destroyed; then H9 against its plain version under H1's gates at the
   shapes of the path (Tq = Tk = 50,000, H = 20, D = 64, no ALIGN pad)
   and of each rank of a 4-rank split of the main batch (12,500 query
   rows over all 50,000 keys, on both forms), and its times there beside
   the bound of the
   rank's same-segment pairs, the plain version, its mma.sync form and, as
   a yardstick only, PyTorch's varlen forward with ``cu_seqlens_q`` over
   the rank's pieces of its segments and ``cu_seqlens_k`` over those
   segments whole; the Hopper form faster on rank 0's queries where every
   tile lies in one segment than where every tile is masked;
11. context-parallel training: a one-rank NCCL world on 127.0.0.1 and its
   ``(data, fsdp, seq)`` mesh of (1, 1, 1); ESM2 at phase 4's size and
   weights with ``checkpointing=True`` on phase 5's ``ckpt@50k`` batch:
   the loss and every leaf's gradient of one step of
   ``ShardedMaskedPLM(model, mesh, seq_axis='seq')`` against
   ``MaskedPLM``'s (the loss equal, each leaf under phase 5's gates; the
   largest difference and the bit-equal leaves logged); then phase 5's
   cell with the sharded trainer, with every launch counter set to 0 just
   before its first step and read just after (H9 66, H10 33, H3 99 of
   which 33 inverse, H1 and H2 never), losses finite and falling, its ms
   per step, real tokens/s, MFU and peak memory beside phase 5's
   ``ckpt@50k``; then both trainers from the same fresh weights for
   ``CP_COMPARE_STEPS`` steps on that batch, each step's loss within
   ``CP_LOSS_REL`` and the params after the first update within
   :func:`compare_updates`' gates; the process group destroyed; then H10 against its plain
   version under H2's gate at the path's shape (Tq = Tk = 50,000) and per
   rank of a 4-rank split of the 50k train batch (12,500 query rows over
   all 50,000 keys, on both forms), and its times there beside the bound
   of the rank's same-segment pairs and zero rows, the plain version, its
   mma.sync form, each pass of its Hopper form alone, PyTorch's varlen backward per rank (a
   yardstick only) and H2 on the whole batch;
12. every ESM2 size beside 650M (``SIZE_RUNS``: 8M, 35M, 150M, 3B, 15B at
   full width and depth, bf16, seed-0 weights, each freed before the
   next): phase 4's inference cell on the main batch (launches exact, the
   4k comparisons, the median of 5 timed forwards, real tokens/s, peak
   memory; init time and peak logged), phase 5's ``nockpt@10k`` cell
   for 8M, 35M, 150M and 3B (10 timed steps for 3B, ``SIZE_TRAIN_REPS``)
   and ``ckpt@50k`` for 8M and 35M, with
   every leaf's gradient checked, under phases 4's and 5's gates; then H1
   and H2 at each head dim of those sizes (``SIZE_HEAD_DIMS``: 16, 24 and
   32 at 20 heads, 128 at 40) on the 50k inference and train batches:
   each held against its plain version on its route and on the other
   form, then timed on its route and on both forms through their C
   entries (H2's Hopper passes alone too) beside its plain version, the
   varlen library call (its ratio logged, not gated) and the bound with
   the exps at the SFU rate as a third term; at 16 and 24, where the
   route is the Hopper form, that form must beat the mma.sync form;
   ESM2-15B, after its bf16 inference cell, ``quantize('4bit')`` on the
   card one layer slice at a time (``SIZE_QUANTIZE``) and the same cell
   again (launches exact: H1 and H3 48; finite log-probs; its time, real
   tokens/s and peak beside the bf16 cell's); (g) on that NF4 model
   phase 14's adapters (rank 16 on query, value, output, every ``b``
   lifted) and ``MaskedPLM(lora_only=True, remat='full')`` with
   checkpointing on phase 5's 10k batch (``SIZE_QLORA``): launches exact
   (H1 96, H2 48, H3 144 of which 48 inverse), finite losses, the adapters
   moved, the trunk bit-unchanged, no frozen or quantized leaf with a
   gradient, the optimizer's state the adapters' two moments exactly, ms
   a step, real tokens/s and peak memory;
13. the memory slice, every line naming the card and its power limit
   (``check_memory``): first, the port's token-embedding gradient
   repeated on the same inputs must give the same bits every time, at
   ESMC's vocabulary and ESM2's (``embedding_backward_repeats``; the
   card's ``aten::embedding_dense_backward`` beside it, logged); (a)
   ESM2-650M (seed-0 weights) on phase 5's ``ckpt@50k`` batch, one step's
   loss, every leaf's gradient and the gradient reaching the token
   embedding with ``remat='attn'`` bit-equal to ``remat='full'``'s
   (``NONDETERMINISTIC_LEAVES``, held under the remat gates instead, is
   empty), then the ``ckpt@50k`` cell with each
   policy (launches exact: H1 66 with 'full', 33 with 'attn'; H2 33; H3
   99), ms per step, real tokens/s, MFU and peak memory side by side;
   (b) the same for ESMC-300M and ESM1b (seeded as in phase 9), with
   phase 5's gradient checks at 4k; (c) phase 11's one-rank
   ``ShardedMaskedPLM(seq_axis='seq')`` cell with ``remat='attn'``:
   gradients bit-equal to ``'full'``'s and H9 33, H10 33 per step; (d)
   ESM2-650M ``nockpt@10k`` with ``optimizer=adam8bit(1e-4)``: the first
   update on the card bit-equal (codes, scales, params) to the same
   arithmetic on the CPU from the same gradients, its state exactly one
   byte per param and moment plus two fp32 scales per leaf, each
   optimizer's step timed alone beside Adam's, then an Adam and an
   ``adam8bit`` cell (10 timed steps, the losses finite and falling) with
   their peaks; (e) ESM2-3B ``nockpt@10k`` with ``adam8bit`` (10 timed
   steps) beside phase 12's Adam peak; (f) ESM2-650M ``nockpt@10k`` with
   ``offload_optimizer=True`` for three steps from fresh weights: each
   loss within ``CP_LOSS_REL`` of the same arithmetic on the card
   (``MasterAdam``: fp32 masters and Adam there), the first equal to
   ``MaskedPLM``'s, each step's parts timed alone (device, grads down,
   host update, params up), the peaks, the host memory the offload holds
   and the cores;
14. the fine-tune slice (``check_finetune``), every line naming the card
   and its power limit: ESM2-650M (seed-0 weights) with LoRA rank 16 on
   query, value and output and the learned-aggregation head (4 heads),
   through ``LabeledDataset`` at 10,000 tokens, truncation 1,000, on full
   batches of seeded sequences at the tasks' lengths (``FT_LENGTHS``:
   GB1's 265 residues; 1,000-1,400 cut to 1,000) and on the synthetic
   GB1-like regression and TF-like binary splits of the task script's
   smoke mode (``benchmarks/tasks.py``'s ``synthetic_splits``, copied;
   20-59 residues): (a) on each task-length batch one
   ``RegressionTrainer`` step from the same params, every ``b`` non-zero,
   with the kernels and with the plain versions: the loss within
   ``FT_LOSS_REL``; every adapter's and head leaf's gradient, every entry,
   under phase 5's gates against a second plain run with the head's ReLU
   pattern of the kernels' run (the head's key bias, 0 in exact
   arithmetic, under ``ZERO_GRAD_REL`` of its kernel's; the head's units
   whose input changed sign between the two runs, at most
   ``FT_MAX_FLIPPED`` of them, logged); frozen leaves without a gradient;
   (b) its launches exact: H1 33, H2 33, H3 66 of which 33 inverse (and
   ``predict``: H1 33, H3 33); (c) each task as ``benchmarks/tasks.py``
   runs it, two epochs of steps, ``validation_metrics``, a
   ``MetricLogger`` line and ``CheckpointManager.save`` each, then the
   latest checkpoint restored into a fresh trainer (params, step and
   predictions bit-equal) and the adapters through ``save_lora`` into a
   fresh model (predictions bit-equal), on the smoke-mode splits; (d) on
   each ``FT_LENGTHS`` batch ms per fine-tune step, real tokens/s, the
   optimizer's state bytes, peak memory and one ``predict``'s time beside
   phase 5's ``nockpt@10k`` MLM step, and each ``validation_metrics``
   pass's seconds in (c);
15. variant scoring, the host data plane, position extension and the CLI
   (``check_phase15``), every line naming the card and its power limit:
   ESM2-650M from seed-0 weights written through the safetensors schema
   and loaded back; (a) ``predict_mask_margin`` on a seeded 265-residue
   sequence (5,300 variants, 9 forwards of (32, 267) on the padded route;
   launches exact: H1 and H3 33 a forward, nothing else), the same bits on
   a second call, against the same call through the plain versions (every
   variant: max|Δscore| <= ``SCORE_MAX_ABS``, Spearman ρ >=
   ``SCORE_MIN_SPEARMAN``), ms a sequence, variants/s and peak memory;
   ``predict_pseudoperplexity`` on it; a seeded 1,500-residue sequence at
   ``max_len`` 1,024 (47 forwards, launches exact; the batches at
   ``LONG_CHECK_STARTS`` under the same gates); (b)
   ``predict_pseudoperplexity_margin`` on a seeded 16-residue peptide
   (launches exact; under ``PPPL_MAX_ABS`` and the ρ gate); (c) a seeded
   FASTA of >= 10 MiB (100-1000 residues) indexed with ``write_fai``:
   ``MaskedFastaTokenDataModule`` batches at 10k from the native reader
   bit-equal to the Python reader's over an epoch, the native one taken,
   host ms a batch of each and of ``Prefetcher`` with 1 and 4 workers;
   ESM2-650M's and ESM2-8M's ``nockpt@10k`` ``MaskedPLM`` steps fed
   through ``Prefetcher`` (copies to the card from pinned memory) beside
   the same batches built on the card first: ms a step, launches exact,
   losses finite, the device's idle share of each under the profiler; (d)
   phase 13's gate on the token embedding's gradient (above); (e) ESM1b at
   full size (seed 5) with the published 1,024-position table: a
   500-residue sequence's log-probs bit-equal after ``extend_positions(...,
   4096)``, a 3,000-residue forward refused before and run after (H1 33,
   no H3), one ``MaskedPLM`` step under ``positions_only_mask`` changing
   ``embed_positions`` and no other leaf (H1 33, H2 33); (f) ``python -m
   esme_tpu_torch.cli score`` in its own process on the same file and
   sequence: 5,300 CSV rows equal to (a)'s scores, its wall time logged;
16. weight quantization (``check_quant``), every line naming the card and
   its power limit: ESM2-650M from seed-0 weights written through the
   safetensors schema; (a) ``ESM.from_pretrained(path, quantization=m)``
   for ``m`` in 8bit and 4bit (quantized on the host as it is read): the
   load's seconds, the leaves' bytes and the device memory allocated
   after it and at its peak, at most the leaves' bytes and
   ``QUANT_LOAD_SLACK`` (the dense linears never reach the card);
   ``quantize(m)`` of the dense model on the card bit-equal, leaf by leaf
   and dtypes included, to the same call on the CPU (how many leaves the
   two routes share is logged: ROADMAP.md Queue 3, item 23); (b) each
   loaded model through phase 4's comparisons on the 4k batch (launches
   exact: H1 and H3 33, no H2) and against the dense model on the same
   weights, per-token cosine of the log-probs above ``QUANT_MIN_COS`` (8bit
   0.999, 4bit 0.99); ``benchmarks/quant_accuracy.py``'s cell under the
   same gates, on its weights (JAX's seed-0 draw, ``jax_seed_params``) and
   its batch, without and with its ``inject_outliers`` (8 rows x 20 per
   linear, seed 7); ESMC-300M (seeded as in phase 9) loaded in 4bit under
   the same gates; (c) the 50k inference cell dense, 8bit, 4bit, dense
   (launches exact; median of 5, real tokens/s, peak memory), one
   forward's dequantization alone (CUDA events, beside its bytes' bound),
   ``predict_mask_margin`` on phase 15's 265-residue sequence dense and
   4bit (ms a sequence, variants/s); (d) phase 14's ``gb1_265``
   ``RegressionTrainer`` step over the trunk quantized to NF4 on the card
   (LoRA rank 16 on query, value, output; the 4-head aggregation head):
   loss and gradients against the plain versions under phase 14's rule,
   no quantized leaf with a gradient, launches exact (H1 33, H2 33, H3 66
   of which 33 inverse), ms a step, real tokens/s, peak and optimizer
   bytes beside phase 14's dense step; (e) the NF4 model through
   ``save_pretrained`` and ``ESM.from_pretrained``: every leaf and the
   log-probs bit-equal, the file without its ``qoutlier_*`` keys refused.
   With ``--profile``, each quantized forward's table
   (``profile_quant_<mode>.txt``);
17. LoRA over the mesh and resume (``check_phase17``), every line naming
   the card and its power limit: (a) ESM2-650M (seed-0 weights) with
   phase 14's adapters in a one-rank NCCL world on a (1, 1, 1) mesh, on
   phase 5's ``nockpt@10k`` batch: one step's loss of
   ``ShardedMaskedPLM(lora_only=True, seq_axis='seq')`` within
   ``CP_LOSS_REL`` of ``MaskedPLM(lora_only=True)``'s and every adapter's
   gradient under phase 5's gates, the same leaves frozen; then each
   trainer's cell (``LORA_REPS`` timed steps after a warm-up; launches
   exact: H9 33, H10 33, H3 66 of which 33 inverse, H1 and H2 never for
   the sharded trainer, H1 33, H2 33, H3 66 for ``MaskedPLM``), ms a step,
   real tokens/s, peak memory, and after its steps no frozen view with a
   gradient, the frozen leaves bit-unchanged, every adapter moved, the
   optimizer's state exactly the adapters' two Adam moments; (b) the
   same over the trunk quantized to NF4 on the card (no quantized leaf
   with a gradient); (c) resumes through ``CheckpointManager`` in a
   temporary directory: ``MaskedPLM`` with Adam, with
   ``offload_optimizer=True`` and (a)'s sharded trainer, each cut after
   ``RESUME_CUT`` steps, saved, restored into a fresh trainer: the next
   step's loss and every param bit-equal to the uninterrupted run's; the
   checkpoint's bytes and its save and restore seconds logged.
18. a sharded training state restored on a mesh of another shape
   (``check_phase18``), every line naming the card and its power limit,
   for each cell of ``RESHARD_CELLS`` in a one-rank NCCL world on a (1, 1,
   1) mesh: (a) ``ShardedMaskedPLM(grad_accum=2, seq_axis='seq')`` over
   ESM2-650M (seed-0 weights) trains ``RESHARD_CUT`` micro-steps on phase
   5's ``nockpt@10k`` batch (one update, a cycle left open) and
   ``CheckpointManager`` saves its part; (b) a gloo world of spawned
   processes on the host (another machine's ranks; they import only the
   port, build the model's skeleton with zero weights, run no forward and
   take ``RESHARD_HOST_THREADS`` threads each) restores that checkpoint on
   the cell's mesh and saves it again; (c) a fresh trainer on the card
   restores (b)'s parts: every param, optimizer tensor and scalar, the step
   and the open cycle's gradients bit-equal to (a)'s saved part, the next
   micro-step's loss and every param after it bit-equal to the
   uninterrupted run's, its launches exact (H9 33, H10 33, H3 66 of which
   33 inverse, H1 and H2 never). Cells: every leaf under Adam with the host
   world on (2, 2, 1); phase 14's adapters over the trunk quantized to NF4
   on the card, ``lora_only`` under ``adam8bit`` (e5m2 codes, the frozen
   uint8 and int32 leaves), its host world on (1, 2, 1). Each replicated
   shard is written once: in (b)'s parts, those at a ``data`` or ``seq``
   coordinate other than 0 hold no param or optimizer tensor (gate), and
   each part's bytes are logged. Logged: the checkpoints' bytes, the save
   and restore seconds on the card and on the host, the host ranks' peak
   resident memory.
19. trainer states restored by leaf path (``check_phase19``), every line
   naming the card and its power limit: ESM2-650M (bf16, seed-0 weights
   written to a safetensors file) in three cells, each saving trainer A's
   state through ``CheckpointManager`` and restoring it into a fresh
   trainer B whose params tree lists the same leaves in another order
   (gate: the orders differ); B's resumed step bit-equal to A's
   uninterrupted one, its loss and every param by path (a leaf held in
   another dtype, NF4's outlier rows, by value), its launches exact (H1
   33, H2 33, H3 66 of which 33 inverse). (a) ``MaskedPLM`` under Adam with
   ``grad_accum=2`` on phase 5's ``nockpt@10k`` batch, cut after
   ``STATE_CUT`` micro-steps (mid-cycle), A over ``from_pretrained``, B
   over the same weights in ``params_from_jax``'s sorted order; (b) phase
   14's adapters over NF4, ``lora_only`` under ``adam8bit``, A over
   ``from_pretrained(quantization='4bit')``, B over
   ``from_pretrained(...).quantize('4bit')``; (c) ``RegressionTrainer``
   with phase 14's adapters and aggregation head on the ``gb1_265``
   batch, B's trees in reverse key order. Logged: each checkpoint's bytes,
   save and restore seconds.

20. the mesh on N cards (``--ranks N`` alone): the kernels built once, in
   the parent, then one spawned process per card, which joins a process
   group (NCCL, ``WORLD_TIMEOUT_S`` for it and every group of its meshes)
   for each cell with the ranks the cell's world holds; the parent stops
   every rank as soon as one fails, or after ``RANKS_DEADLINE_S``.
   Launches are exact on every rank in every cell. (a) phase 10's cell
   through ``context_parallel_log_prob`` on ``seq`` = 1, 2 and 4 cards:
   the weights the same on every rank, each rank's (T, V) log-probs under
   phase 4's gate against its card's ``predict_log_prob`` (bit equality
   logged), ms a forward, real tokens/s, peak memory, one k gather's bus
   bandwidth, the NCCL kernels' device time of a profiled forward on rank
   0; (b) phase 11's ``ckpt@50k`` through ``ShardedMaskedPLM(seq_axis=
   'seq')`` on (1, 1, 2), (1, 1, 4), (1, 2, 2) and (1, 4, 1), each three
   steps from the seed-0 weights against ``MaskedPLM`` on one card (losses
   within ``CP_LOSS_REL``, :func:`compare_updates` after the first
   update), ms a step, real tokens/s, MFU, peak on every card, and a
   profiled step's all-gathers, reduce-scatters and all-reduces and their
   overlap with compute on rank 0; (c) phase 17's adapters, dense and
   NF4, on ``nockpt@10k`` through ``ShardedMaskedPLM(lora_only=True,
   seq_axis='seq')`` on (1, 4, 1) and (2, 2, 1) (two data rows, two
   batches) against the single-device gradient of the global masked mean
   under phase 17's gates, :func:`trainer_checks` on every rank; (d)
   phase 18's dense state saved by 4 ranks on (2, 2, 1) (each rank's
   write seconds), resumed there bit for bit and restored on one card,
   then a one-card state restored on (1, 4, 1), each resumed step against
   the uninterrupted one under phase 11's gates, a replica's part without
   param or optimizer tensors; (e) ESM2-15B trained fully over FSDP on (1,
   4, 1) (``remat='full'``, Adam): 2 layers at full width against
   ``MaskedPLM`` on one card, then 48 layers at 10k and, where it fits,
   50k tokens: losses finite and falling, ms a step, real tokens/s, MFU,
   peak a card, host memory a rank; then on rank 0 H9, H10 and H3 at the
   cells' per-rank shapes against their plain versions, timed beside
   their bounds, plain versions and the varlen library call.

Each phase's seconds are logged and kept in the measurements line
(``phase_s``). The last three lines are the kernels' JSON, the measurements' JSON and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

# Published H100 SXM peaks (dense): HBM rate and bf16 tensor-core rate,
# and the fp32 rate outside the tensor cores for elementwise work.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# The SFU's exponentials, 16 per SM per clock (Shah et al.,
# FlashAttention-3, 2024, section 3.1; esme_tpu_torch/tools' figure)
SFU_EXP_PER_S = 3.9e12

# Gates of phase 3, kernel vs plain version on the same bf16 inputs.
# o: each output is rounded to bf16, and the kernel rounds p to bf16
# against the running row max where the plain version uses the final
# one, so the two differ by up to one ulp of o, plus a small absolute
# part from p. The gate follows o's own scale: |o - o_plain| <= 2^-6 *
# max(|o_plain|, 1/4), two to four bf16 ulps of |o| for |o| >= 1/4 and
# 3.9e-3 below it (a one-ulp difference at the edge of a binade, such
# as 0.49609375 against 0.5, is a whole ulp of the larger value). A
# wrong v row or a misplaced store moves o by about its own size
# (|o| ~ 0.05-0.5 here).
# lse: both keep m, l and lse in fp32 and differ in summation order.
FLASH_O_REL, FLASH_O_FLOOR = 2.0 ** -6, 0.25
FLASH_LSE_ATOL = 1e-4
# H2: p and ds are rounded to bf16 before their products. Where the
# kernel's fp32 ds (mma.sync sums, exp2) and the plain version's
# (cuBLAS sums, exp) differ in their last fp32 bits, the two roundings
# can land on neighbouring bf16 values, and one such flip of a large ds
# term moves one gradient element by up to ~2^-8·|ds|·|k|: measured up
# to 0.019·rms(g) at 8k tokens, where a float64 sum with the same
# roundings sided with the kernel as often as with the plain version.
# Each gradient is then rounded to bf16 once. The gate follows each
# tensor's own scale: |g - g_plain| <= 2^-4 * max(|g_plain|,
# rms(g_plain)). A wrong row, a missed tile or a misplaced store moves
# g by about its own size.
FLASH_G_REL = 2.0 ** -4
# Phase 4: the model with kernels vs with plain versions (and vs its
# einsum attention path) at full depth, on the centred per-token
# log-probability vectors, real tokens only: bf16 rounding differences
# in attention carried through 33 layers.
MODEL_MIN_COS = 0.99
MODEL_MAX_ABS = 0.25
LOGSUMEXP_ATOL = 1e-4
# Phase 5: every leaf's gradient of one masked-LM step at full depth with
# kernels vs with plain versions: bf16 rounding differences in attention
# (H1 and H2 within two to four ulps of their plain versions) carried
# through 33 layers forward and back. Per leaf: cosine and the largest
# difference relative to the leaf's largest gradient (measured on the
# H100: cosine 0.998989 or more, 0.0213 · max|g| or less).
GRAD_MIN_COS = 0.99
GRAD_MAX_REL = 0.1
# With remat='full' against without: the same kernels and products
# recomputed, deterministic (no atomics anywhere), so bit-equal is
# expected; the gate allows one bf16 rounding of the leaf's largest
# value and the loss must be equal. (The cosine of two equal vectors
# computed in fp32 can fall a few 1e-7 below 1.)
REMAT_MIN_COS, REMAT_MAX_REL = 0.9999, 2.0 ** -8
# Without RoPE (ESM1b, ESM1v) k's bias adds one constant to each row of
# scores, which the softmax removes: its gradient is 0 in exact arithmetic,
# and what either side computes is the bf16 rounding of ds (each row of ds
# sums to 0 before it) summed over the keys, noise with no scale of its
# own and no cosine to compare. That leaf is held to be noise on both
# sides: at most ZERO_GRAD_REL of the largest gradient of k's kernel.
ZERO_GRAD_REL = 2.0 ** -4

H1_NAME, H2_NAME, H3_NAME, H4_NAME = (
    'segment_flash_fwd', 'segment_flash_bwd', 'rotary_qk', 'relayout_heads')
# H9, the rectangular forward (segment_flash_fwd with seg_k), counted on
# H1's wrapper under its own name (rect_launches); H10, the rectangular
# backward (segment_flash_bwd with seg_k), likewise on H2's
H9_NAME = 'segment_flash_fwd_rect'
H10_NAME = 'segment_flash_bwd_rect'
# the probe tools' kernels (esme_tpu_torch/tools): H5, H6 (H1's ablation
# modes), H7 (H2's) and the four H8 probes; none is on the model path
H5_NAME, H6_NAME, H7_NAME = 'fwd_T', 'variant_fwd', 'bwd_variant'
H8_NAMES = ('probe_vpu', 'probe_mxu', 'probe_dma', 'probe_dma_t')
# The times of H1's and H2's mma.sync forms at the main shapes before the
# ablation modes were added (PERF.md's kernel table), on REF_CARD. The
# mode-0 instantiations are held to within 3% of them there, on the better
# of the script's two timings of each (phase 7's and phase 8's); another
# card or power limit moves them, and there they are logged only.
H1_REF_MS, H2_REF_MS = 1.0984, 4.1524
REF_CARD = 'NVIDIA H100 80GB HBM3, 700.00 W'
# ptxas' report of the same instantiations before the modes were added
# (registers by padded head dim; no stack frame and no spills at any):
# the build must give them unchanged.
MODE0_REGISTERS = {
    ('flash_fwd', 'flash_fwd_kernel'): {16: 135, 32: 185, 64: 237, 128: 191},
    ('flash_bwd', 'flash_bwd_dq_kernel'): {16: 88, 32: 123, 64: 158,
                                           128: 182},
    ('flash_bwd', 'flash_bwd_dkv_kernel'): {16: 96, 32: 160, 64: 170,
                                            128: 255},
}

# H4's moves as the ops make them: (sources, destinations, rotations) of
# the tensors of one launch; 'R' is RoPE, 'RT' its transpose, 'N' none.
# The first is the kernel's headline mode (K11, the three-tensor split).
RELAYOUTS = {
    'split (K11)': ('thd', 'htd', 'R R N'),
    'split, R^T (K11)': ('thd', 'htd', 'RT RT N'),
    'merge (K12; K13 back)': ('htd', 'thd', 'N'),
    'merge, R (K12)': ('htd', 'thd', 'R'),
    'merge, R^T (split back)': ('htd', 'thd', 'RT RT N'),
    'split one (K13)': ('thd', 'htd', 'N'),
    'split_t (K7)': ('thd', ('htd', 'hdt', 'hdt'), 'R R N'),
    'split_t q_minor (K8, K9)': ('thd', 'hdt', 'R R N'),
    'merge_t, R^T (K10)': ('hdt', 'thd', 'RT'),
    'to thd (fwd_v2)': (('htd', 'hdt', 'hdt'), 'thd', 'N N N'),
    'to hdt (flash_tm)': ('thd', 'hdt', 'N'),
    'from hdt (flash_tm)': ('hdt', 'thd', 'N'),
}

# The tile kernel's times of H4's moves without rotation that have an hdt
# side, at the main shape on REF_CARD before the vec kernel took them
# (PERF.md's H4 modes): the vec kernel's ratio to each is logged.
H4_TILE_REF_MS = {'to thd (fwd_v2)': 0.2812, 'to hdt (flash_tm)': 0.0979,
                  'from hdt (flash_tm)': 0.0978}

# Phase 3's extra H2 batches (``layout_seg``)
BWD_LAYOUTS = ('one', 'short', 'interleaved')

# Sizes: ESM2-650M at full width and depth, bench.py's 50k-token batch,
# the 8k-token batch of the kernel checks (where the plain version's
# scores fit), the 4k-token batch of the full-depth comparisons, the
# train cells' budgets (bench.py's nockpt@10k and ckpt@50k) and the
# fit's budget.
MODEL = dict(num_layers=33, embed_dim=1280, attention_heads=20)
BUDGET = 50_000
CHECK_BUDGET = 8192
SMALL_BUDGET = 4096
# (key, budget, checkpointing, timed steps, loss must fall): the 50k
# cell starts from the 10k cell's weights with a fresh Adam, whose first
# updates (lr·sign(g) on every leaf) raise the loss before it falls, so
# only its losses' finiteness is checked there
TRAIN_CELLS = (('nockpt', 10_000, False, 5, True),
               ('ckpt', 50_000, True, 3, False))
FIT_BUDGET = 8192
# Phase 9, the other families at full width and depth: (metadata name,
# class, constructor arguments, runs). Runs: 'infer' the inference cell
# on the main batch, 'plain' the kernels-vs-plain comparison on the 4k
# batch, 'train' TRAIN_CELLS' nockpt@10k cell and every leaf's gradient
# against plain versions, 'overflow' the position table's guard.
FAMILY_RUNS = (
    ('esmc_300m', 'ESMC', {}, ('infer', 'plain', 'train')),
    ('esm1b', 'ESM1b', {}, ('infer', 'plain', 'train', 'overflow')),
    ('esmc_600m', 'ESMC', dict(num_layers=36, embed_dim=1152,
                               attention_heads=18), ('infer', 'plain')),
    ('esm1v_t33_650m_ur90s_1', 'ESM1v', {}, ('plain',)),
)
# ESMC-300M's and ESMC-600M's head counts (D = 64), checked on the 8k
# batch; the first also timed at the main shapes
FAMILY_HEADS = (15, 18)
DEVICE = 'cuda'
FWD_REPS = 5           # timed forwards of the main path, after one warm-up
# fastest_calls' spin ahead of each timed call: ~10 ms at the H100's
# 1.98 GHz boost clock, longer at a lower clock
SPIN_CYCLES = 20_000_000
# Published H100 SXM dense bf16 peak for MFU (bench.py's formula)
MFU_PEAK = BF16_FLOP_PER_S


# ' rank r' in a rank process of phase 20 (``--ranks N``), '' elsewhere
RANK_TAG = ''


def fail(msg: str):
    print(f'chip_smoke{RANK_TAG}: FAIL: {msg}', file=sys.stderr, flush=True)
    if RANK_TAG:
        # at once: a process group's teardown could wait on ranks that
        # wait on this one; the parent sees the code and stops the rest
        sys.stdout.flush()
        os._exit(1)
    sys.exit(1)


def log(msg: str):
    print(f'[chip_smoke{RANK_TAG}] {msg}', flush=True)


def packed_batch(budget: int, seed: int):
    """``bench.py``'s packed batch: sequences of 100-1000 aa (+2) until
    the budget is within 1024 of full, random residue tokens, a padding
    tail. Returns ``(tokens, cu_lens, max_len)`` as numpy."""
    from esme_tpu_torch.alphabet import Alphabet
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < budget - 1024:
        n = int(rng.integers(100, 1000))
        lens.append(n + 2)
        total += n + 2
    cu = np.cumsum([0, *lens]).astype(np.int32)
    tokens = np.full(budget, Alphabet.padding_idx, np.int32)
    tokens[:cu[-1]] = rng.integers(4, 24, cu[-1])
    return tokens, cu, int(max(lens))


def flat_meta(cu, budget: int, dev):
    """Segment ids, positions and H1 spans through the functions
    ``_ESMBase._run`` and ``forward_flat`` make them with."""
    from esme_tpu_torch.models.esm import pad_flat_meta, packed_meta
    return pad_flat_meta(*packed_meta(torch.as_tensor(cu, device=dev),
                                      budget))


def randn(shape, gen, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_inputs(cu, budget, H, D, dev, seed):
    seg, pos, spans = flat_meta(cu, budget, dev)
    T = seg.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (randn((T, H * D), gen, dev) for _ in range(3))
    return q, k, v, seg, pos, spans


def o_errors(o, o_p):
    """max|o - o_plain| and its largest share of the o gate (<= 1
    passes)."""
    d = (o.float() - o_p.float()).abs()
    gate = FLASH_O_REL * o_p.float().abs().clamp_min(FLASH_O_FLOOR)
    return d.max().item(), (d / gate).max().item()


def flash_errors(o, lse, o_p, lse_p):
    """max|o - o_plain|, its largest share of the o gate (<= 1 passes)
    and max|lse - lse_plain|."""
    return (*o_errors(o, o_p), (lse - lse_p).abs().max().item())


def check_flash(cu, budget, H, D, dev, seed=0, what=''):
    """H1 vs its plain version on a packed batch; returns (o err, lse
    err)."""
    q, k, v, seg, _, spans = flash_inputs(cu, budget, H, D, dev, seed)
    return check_flash_args((q, k, v, seg, *spans[:2], H), what)[:2]


def check_flash_args(args, what='', seg_k=None, library=None):
    """H1 (on its route, or through ``library``'s C entry) vs its plain
    version on ``segment_flash_fwd``'s arguments, under H1's gates, and
    bit-equal across two calls; with ``seg_k``, H9 (the keys' own ids)
    under the same gates. Returns (o err, lse err, o, lse)."""
    from esme_tpu_torch.ops import flash
    q, *_, H = args
    D = q.shape[1] // H
    kw = {} if seg_k is None else {'seg_k': seg_k}
    name = 'H1' if seg_k is None else 'H9'
    form = library or flash.fwd_route(D)
    rows = f'T={q.shape[0]}' if seg_k is None \
        else f'Tq={q.shape[0]} Tk={seg_k.shape[0]}'

    def run():
        if library is None:
            return flash.segment_flash_fwd(*args, **kw)
        return flash.launch_fwd(library, *args, **kw)
    o, lse = run()
    again = run()
    o_p, lse_p = flash.segment_flash_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    e_o, share, e_l = flash_errors(o, lse, o_p, lse_p)
    same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    ok = share <= 1.0 and e_l <= FLASH_LSE_ATOL and same \
        and bool(torch.isfinite(o.float()).all())
    log(f'{name}{what} {rows} H={H} D={D} ({form}): '
        f'max|o-plain| {e_o:.3e}, {share:.3f} of the o gate '
        f'(2^-6*max(|o|, {FLASH_O_FLOOR})), max|lse-plain| {e_l:.3e} (gate '
        f'{FLASH_LSE_ATOL}), bit-equal across two calls {same} '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{name} ({form}) disagrees with its plain version (or itself) '
             f'at {rows} D={D}{what}')
    return e_o, e_l, o, lse


def seg_flash_args(seg, H, D, dev, seed):
    """H1's arguments over given segment ids: random q, k, v and the
    spans."""
    from esme_tpu_torch.ops import flash
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (randn((seg.shape[0], H * D), gen, dev) for _ in range(3))
    return (q, k, v, seg, *flash.flash_spans(seg)[:2], H)


def mma_sync_fwd(args):
    """H1's mma.sync form (``csrc/flash_fwd.cu``), the mode-0 kernel that
    H6 ``baseline`` ablates, through its C entry (no counter moves)."""
    from esme_tpu_torch.ops import flash
    return flash.launch_fwd('flash_fwd', *args)


def bwd_inputs(cu, budget, H, D, dev, seed):
    """H2's inputs: random q, k, v and do, H1's o and lse, delta."""
    from esme_tpu_torch.ops import flash
    q, k, v, seg, _, spans = flash_inputs(cu, budget, H, D, dev, seed)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    do = randn(q.shape, gen, dev)
    return q, k, v, do, lse, flash.attention_delta(o, do, H), seg, spans


def grad_errors(got, ref):
    """Per tensor: max|g - g_plain|, its largest share of the H2 gate
    (<= 1 passes); and whether every g is finite."""
    errs, shares, finite = [], [], True
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        gate = FLASH_G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        errs.append(d.max().item())
        shares.append((d / gate).max().item())
        finite = finite and bool(torch.isfinite(a).all())
    return errs, shares, finite


def layout_seg(layout, T, dev, seed):
    """Segment ids of phase 3's extra H2 batches: ``one`` segment over all
    T (every tile unmasked), ``short`` segments of 1-70 tokens (every
    tile masked) and ``interleaved`` ids 0-2 drawn per token (not
    monotonic: every tile masked, every span the whole batch)."""
    rng = np.random.default_rng(seed)
    if layout == 'one':
        ids = np.zeros(T, np.int32)
    elif layout == 'short':
        ids = np.repeat(np.arange(T), rng.integers(1, 71, T))[:T]
    else:
        ids = rng.integers(0, 3, T)
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def seg_bwd_inputs(seg, H, D, dev, seed):
    """H2's inputs over given segment ids: random q, k, v and do, H1's o
    and lse, delta, the spans."""
    from esme_tpu_torch.ops import flash
    T = seg.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (randn((T, H * D), gen, dev) for _ in range(4))
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    return q, k, v, do, lse, flash.attention_delta(o, do, H), seg, spans


def check_flash_bwd(cu, budget, H, D, dev, seed=0, what=''):
    """H2 vs its plain version on a packed batch; returns (max |error|,
    largest gate share) over dq, dk and dv."""
    return check_bwd_args(bwd_inputs(cu, budget, H, D, dev, seed), H, D,
                          what)


def check_bwd_args(inputs, H, D, what='', library=None):
    """H2 (on its route, or through ``library``'s C entry) vs its plain
    version on ``bwd_inputs``-shaped inputs."""
    from esme_tpu_torch.ops import flash
    q, k, v, do, lse, delta, seg, spans = inputs
    def run():
        if library is None:
            return flash.segment_flash_bwd(q, k, v, do, lse, delta, seg,
                                           *spans, H)
        return flash.launch_bwd(library, q, k, v, do, lse, delta, seg,
                                *spans, H)
    got = run()
    same = all(map(torch.equal, got, run()))
    ref = flash.segment_flash_bwd_plain(q, k, v, do, lse, delta, seg, *spans,
                                        H)
    torch.cuda.synchronize()
    errs, shares, finite = grad_errors(got, ref)
    ok = max(shares) <= 1.0 and finite and same
    log(f'H2{what} T={q.shape[0]} H={H} D={D} '
        f'({library or flash.bwd_route(D)}): '
        f'max|g-plain| dq/dk/dv '
        f'{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, largest share of the '
        f'gate (2^-4*max(|g|, rms g)) {shares[0]:.3f}/{shares[1]:.3f}/'
        f'{shares[2]:.3f}, finite {finite}, bit-equal across two calls '
        f'{same} {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'H2 ({library or flash.bwd_route(D)}) disagrees with its plain '
             f'version (or itself) at T={q.shape[0]} D={D}{what}')
    return max(errs), max(shares)


def check_rope(T, H, D, dev, seed=0):
    """H3 vs its plain version, forward and inverse: bit equality (both
    round each product and each sum to bf16)."""
    from esme_tpu_torch.ops import headsplit
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k = (randn((T, H * D), gen, dev) for _ in range(2))
    pos = torch.randint(0, 1024, (T,), generator=gen, device=dev)
    cos, sin = rotary_cos_sin(pos, D)
    err = 0.0
    for inverse in (False, True):
        got = headsplit.rotary_qk(q, k, cos, sin, H, inverse=inverse)
        ref = headsplit.rotary_qk_plain(q, k, cos, sin, H, inverse=inverse)
        torch.cuda.synchronize()
        e = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f'H3 T={T} H={H} D={D} inverse={inverse}: max|err| {e:.3e}, '
            f'bit-equal {same} (gate: bit equality)')
        if not same:
            fail(f'H3 disagrees with its plain version at D={D}')
        err = max(err, e)
    return err


def relayout_args(mode, T, H, D, dev, seed):
    """H4's arguments for ``RELAYOUTS[mode]``: random bf16 tensors in
    their source layouts and RoPE tables of random positions."""
    from esme_tpu_torch.ops import headsplit
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    src, dst, rot = RELAYOUTS[mode]
    rot = tuple({'N': headsplit.ROT_NONE, 'R': headsplit.ROT_R,
                 'RT': headsplit.ROT_RT}[r] for r in rot.split())
    srcs = (src,) * len(rot) if isinstance(src, str) else src
    shapes = {'thd': (T, H * D), 'htd': (H, T, D), 'hdt': (H, D, T)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xs = tuple(randn(shapes[s], gen, dev) for s in srcs)
    pos = torch.randint(0, 1024, (T,), generator=gen, device=dev)
    cos, sin = rotary_cos_sin(pos, D)
    return xs, src, dst, H, rot, cos, sin


def check_relayout(T, H, D, dev):
    """H4 vs its plain version in every mode, on the route its rule picks
    (``relayout_route``; the route counter must show it) and, where that
    is the vec kernel, on the tile kernel launched by name too: bit
    equality (the rotation rounds each product and each sum to bf16 as
    the plain version does; a move without rotation copies the bits)."""
    from esme_tpu_torch.ops import headsplit
    routes = set()
    for i, mode in enumerate(RELAYOUTS):
        args = relayout_args(mode, T, H, D, dev, seed=D + i)
        route = headsplit.relayout_route(*args[1:3], T)
        before = dict(headsplit.relayout_heads.routes)
        runs = {route: headsplit.relayout_heads(*args)}
        moved = {n: c - before[n]
                 for n, c in headsplit.relayout_heads.routes.items()}
        if moved != {n: int(n == route) for n in moved}:
            fail(f'H4 {mode} at T={T} D={D} launched {moved}, not once on '
                 f'{route}')
        if route == 'vec':
            runs['tile'] = headsplit.launch_relayout('tile', *args)
        ref = headsplit.relayout_heads_plain(*args)
        torch.cuda.synchronize()
        for name, got in runs.items():
            routes.add(name)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                e = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref))
                fail(f'H4 {mode} ({name}) at T={T} H={H} D={D} differs '
                     f'from its plain version by up to {e:.3e} (gate: bit '
                     'equality)')
    log(f'H4 T={T} H={H} D={D}: all {len(RELAYOUTS)} modes bit-equal to '
        f'the plain version on the routes {sorted(routes)} (gate: bit '
        'equality) ok')


@contextlib.contextmanager
def plain_versions():
    """Route attention, forward and backward, through the kernels' plain
    versions: the model's (phases 4 and 5) and the op API's (phase 6),
    for their comparisons only. Fails if a kernel launched inside: its
    counter is read on the wrapper itself, before and after."""
    from esme_tpu_torch.ops import flash, flash_v2, fused_attn, headsplit
    kernels = _counters()
    before = _launch_totals(kernels)
    swaps = [(m, n, getattr(flash, n + '_plain')) for m in
             (fused_attn, flash, flash_v2) for n in
             ('segment_flash_fwd', 'segment_flash_bwd') if hasattr(m, n)]
    swaps += [(m, 'rotary_qk', headsplit.rotary_qk_plain)
              for m in (fused_attn, headsplit)]
    swaps += [(m, 'relayout_heads', headsplit.relayout_heads_plain)
              for m in (headsplit, flash_v2)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    after = _launch_totals(kernels)
    if after != before:
        fail(f'a kernel launched while its plain version stood in: '
             f'{before} -> {after}')


def _launch_totals(kernels):
    c = {name: f.launches for name, f in kernels.items()}
    c[H9_NAME] = kernels[H1_NAME].rect_launches
    c[H10_NAME] = kernels[H2_NAME].rect_launches
    c['rope_inverse'] = kernels[H3_NAME].inverse_launches
    return c


def compare_logp(got, ref, what):
    a = got - got.mean(-1, keepdim=True)
    b = ref - ref.mean(-1, keepdim=True)
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    c, e = cos.min().item(), (got - ref).abs().max().item()
    m = (got - ref).abs().mean().item()
    ok = c >= MODEL_MIN_COS and e <= MODEL_MAX_ABS
    log(f'{what}: min cosine {c:.6f} (gate {MODEL_MIN_COS}), max|err| '
        f'{e:.4f} (gate {MODEL_MAX_ABS}), mean|err| {m:.5f} '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{what} out of gate')
    return {'min_cos': c, 'max_abs': e, 'mean_abs': m}


def inference_run(model, batch, what, expected):
    """One packed ``predict_log_prob(tokens, pad_args=(cu_lens,
    max_len))`` on ``batch`` with the launch counters set to 0 just
    before and read just after (fails unless they equal ``expected``);
    the log-probs finite rows of the model's vocabulary that sum to 1.
    Returns the launches."""
    tokens, cu, max_len = batch
    real = int(cu[-1])
    reset_counters()
    lp = model.predict_log_prob(tokens, pad_args=(cu, max_len))
    torch.cuda.synchronize()
    launches = read_counters()
    log(f'{what} launches per forward: {launches} (expected {expected})')
    if launches != expected:
        fail(f'{what}: a kernel of the inference path launched {launches}, '
             f'not {expected}')
    V = model.config.vocab_size
    if tuple(lp.shape) != (len(tokens), V) or lp.dtype != torch.float32:
        fail(f'{what}: log-probs have shape {tuple(lp.shape)} {lp.dtype}')
    lpr = lp[:real]
    lse_err = lpr.logsumexp(-1).abs().max().item()
    finite = bool(torch.isfinite(lp).all())
    log(f'{what}: log-probs finite {finite}, max|logsumexp| {lse_err:.2e} '
        f'(gate {LOGSUMEXP_ATOL})')
    if not finite or lse_err > LOGSUMEXP_ATOL:
        fail(f'{what}: log-probs are not finite normalised rows')
    del lp, lpr
    return launches


def inference_times(model, batch, what):
    """``FWD_REPS`` timed forwards of ``inference_run``'s call (CUDA
    events, the first after a warm-up), the host's enqueue time and peak
    memory: the cell's measurements."""
    tokens, cu, max_len = batch
    real = int(cu[-1])
    torch.cuda.reset_peak_memory_stats()
    samples = [cuda_ms(lambda: model.predict_log_prob(
        tokens, pad_args=(cu, max_len)), reps=1, warmup=int(i == 0))
        for i in range(FWD_REPS)]
    ms = float(np.median(samples))
    t0 = time.perf_counter()
    model.predict_log_prob(tokens, pad_args=(cu, max_len))
    host_ms = (time.perf_counter() - t0) * 1e3     # enqueue, no sync
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f'{what}: median {ms:.2f} ms per batch of {FWD_REPS} '
        f'(min {min(samples):.2f}, max {max(samples):.2f}), '
        f'{real / ms * 1e3:.1f} real tokens/s, peak memory '
        f'{peak / 2**30:.2f} GiB; host returns after {host_ms:.2f} ms')
    torch.cuda.empty_cache()
    return {'ms_per_batch': ms, 'ms_per_batch_samples': samples,
            'real_tokens_per_s': real / ms * 1e3,
            'peak_mem_gib': peak / 2**30, 'host_enqueue_ms': host_ms}


def plain_checks(model, what):
    """At full depth on the 4k batch (bench.py's recipe, seed 2): the
    model with kernels, its launches exact (H1 per layer, H3 per layer
    where it has RoPE), against the model with the kernels' plain
    versions and against its einsum attention path, under phase 4's
    gates."""
    cfg = model.config
    L = cfg.num_layers
    stok, scu, sml = packed_batch(SMALL_BUDGET, seed=2)
    sreal = int(scu[-1])
    reset_counters()
    small = model.predict_log_prob(stok, pad_args=(scu, sml))[:sreal]
    torch.cuda.synchronize()
    expect_launches(f'{what}{L} layers, {sreal} tokens', read_counters(),
                    **{H1_NAME: L, H3_NAME: L if cfg.rotary else 0})
    with plain_versions():
        small_plain = model.predict_log_prob(stok, pad_args=(scu, sml))
    small_ref = model.predict_log_prob(stok, pad_args=(scu, sml),
                                       attn_impl='reference')
    checks = {
        'vs_plain': compare_logp(small, small_plain[:sreal],
                                 f'{what}{L} layers, {sreal} tokens: kernels '
                                 f'vs plain versions'),
        'vs_einsum': compare_logp(small, small_ref[:sreal],
                                  f'{what}{L} layers, {sreal} tokens: kernels '
                                  f'vs einsum attention'),
    }
    del small, small_plain, small_ref
    torch.cuda.empty_cache()
    return checks


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
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


def bound(nbytes: float, flops: float, flop_rate: float):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / flop_rate
    return max(t_b, t_f) * 1e3, 'bytes' if t_b >= t_f else 'operations'


def flash_work(q, seg, ks, H, D):
    """Bytes H1 must move and the operations its segments need: q, k, v
    read and o written once, lse written, segment ids and spans read;
    2·2·D flops per same-segment (q, k) pair and head (QKᵀ and PV)."""
    T = q.shape[0]
    nbytes = 4 * q.numel() * q.element_size() + H * T * 4 + T * 4 \
        + 2 * ks.numel() * 4
    counts = torch.unique_consecutive(seg, return_counts=True)[1].double()
    flops = 4.0 * D * H * float((counts ** 2).sum().item())
    return nbytes, flops


def flash_bwd_work(q, seg, spans, H, D):
    """Bytes H2 must move and the operations its segments need: q, k, v
    and do read and dq, dk, dv written once, lse and delta read, segment
    ids and spans read; five products of 2·D flops per same-segment
    (q, k) pair and head (S, dP, dV, dK, dQ)."""
    T = q.shape[0]
    nbytes = 7 * q.numel() * q.element_size() + 2 * H * T * 4 + T * 4 \
        + sum(x.numel() for x in spans) * 4
    counts = torch.unique_consecutive(seg, return_counts=True)[1].double()
    flops = 10.0 * D * H * float((counts ** 2).sum().item())
    return nbytes, flops


def mask_units(seg, spans):
    """Counts, from a batch's segment ids, of the units on which H2's
    Hopper form decides the mask (a warp's 16 rows against one 64-row
    tile), per pass: ``{pass: (unmasked, total)}``. A property of the
    batch, worked out here by the kernel's rule, not read from the card
    (``time_mask_skip`` and ``time_fwd_mask_skip`` measure the skip). A
    unit is unmasked when its 16 rows (existing) and the tile's 64 ids
    share one id: in the dk/dv pass the k rows against a q tile of the
    block's span (ids past T read as 0, as the kernel's zero-filled copies
    do), in the dq pass the q rows against a k tile that lies wholly below
    T. The dq pass walks H1's spans, so its count is also the batch's
    (16-row, 64-key) units of the forward."""
    INT_MIN = -2 ** 31
    seg = seg.long().cpu()
    T = seg.numel()
    kstart, kend, qstart, qend = (s.long().cpu() for s in spans)

    def slices(ids):              # per 16 rows: the common id or None
        ids = torch.cat([ids, torch.full(((-T) % 128,), INT_MIN)])
        s16 = ids.view(-1, 16)
        return torch.where((s16 == s16[:, :1]).all(1), s16[:, 0], INT_MIN)

    def tiles(ids, pad):          # per 64 ids: the common id or a miss
        t64 = torch.cat([ids, torch.full(((-T) % 64,), pad)]).view(-1, 64)
        return (t64 == t64[:, :1]).all(1), t64[:, 0]

    r16 = slices(seg)
    counts = {}
    rows = 128                    # per CTA in either pass
    for name, spans_, pad in (('dkv', (qstart, qend), 0),
                              ('dq', (kstart, kend), INT_MIN)):
        uni, first = tiles(seg, pad)
        start, end = spans_
        if name == 'dkv':             # the union of two 64-row spans
            pad2 = (-start.numel()) % 2
            start = torch.cat([start, start[-1:].expand(pad2)]).view(-1, 2) \
                .amin(1)
            end = torch.cat([end, end[-1:].expand(pad2)]).view(-1, 2).amax(1)
        unmasked = total = 0
        for b in range(start.numel()):
            t = torch.arange(int(start[b]), int(end[b]))
            sl = r16[b * rows // 16:(b + 1) * rows // 16]
            hit = uni[t][None, :] & (first[t][None, :] == sl[:, None]) \
                & (sl[:, None] != INT_MIN)
            unmasked += int(hit.sum())
            total += sl.numel() * t.numel()
        counts[name] = (unmasked, total)
    return counts


def sm90_pass(which, args):
    """One pass of H2's Hopper form alone, through its C entry
    ``esme_flash_bwd_sm90_pass`` on ``segment_flash_bwd``'s arguments (no
    counter moves): ``which`` 0 writes dk and dv, 1 writes dq; the
    outputs it does not write are left uninitialised."""
    from esme_tpu_torch import _build
    from esme_tpu_torch.ops import flash
    q, *_, H = args
    T, HD = q.shape
    outs = [torch.empty_like(q) for _ in range(3)]
    lib = _build.library('flash_bwd_sm90')
    entry = 'esme_flash_bwd_sm90_pass'
    rc = getattr(lib, entry)(
        which, 0, *(x.data_ptr() for x in (*args[:11], *outs)), T, H,
        HD // H, 1.0 / math.sqrt(HD // H),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, lib, flash.BWD_ROUTES['flash_bwd_sm90'][1], entry)
    return outs


def mask_skip_segs(T, dev):
    """The segment ids of the mask-skip pair: T tokens of one segment
    (every tile unmasked), and the same with the token at 37 of each
    64-token tile given an id of its own (the same spans, every tile
    masked)."""
    one = torch.zeros(T, dtype=torch.int32, device=dev)
    cut = one.clone()
    cut[37::64] = torch.arange(1, cut[37::64].numel() + 1, dtype=torch.int32,
                               device=dev)
    return {'one segment': one, 'every tile masked': cut}


def fastest_calls(what, runs):
    """Each of ``runs`` (name -> a call), one call at a time after a 0.2 s
    pause, eight each in the order first, ..., last, last, ..., first,
    four times. On the H100 at 700 W, back-to-back calls of 50-60 ms
    drifted by up to 10%; after the pause they agree within ~2%, and a
    kernel's time is its fastest call. A call is timed on the card alone:
    a spin (``torch.cuda._sleep``, ``SPIN_CYCLES``) is queued before the
    start event, so the host's work before the launch overlaps the spin
    instead of landing between the events (that work, 10-70 us more in a
    checking wrapper than in a bare C-entry call, took H7 ``real`` to
    1.0317 of H2's own pass in one H100 run). Logs the calls, the shortest
    spin and the longest host call, which must stay below it for the
    times to hold the card's work alone; returns ``{name: {'min': ms,
    'median': ms}}``."""
    times = {name: [] for name in runs}
    spin_ms, host_ms = [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for name in [*runs, *reversed(runs)] * 4:
        time.sleep(0.2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        runs[name]()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev[2].record()
        torch.cuda.synchronize()
        spin_ms.append(ev[0].elapsed_time(ev[1]))
        times[name].append(ev[1].elapsed_time(ev[2]))
    calls = {n: [round(x, 4) for x in t] for n, t in times.items()}
    log(f'{what}: fastest call '
        + ', '.join(f'{n} {min(t):.4f} ms' for n, t in times.items())
        + f'; calls {calls}; shortest spin {min(spin_ms):.3f} ms, longest '
        f'host call {max(host_ms):.3f} ms')
    if max(host_ms) >= min(spin_ms):
        fail(f'{what}: a host call ({max(host_ms):.3f} ms) outlasted the '
             f'spin ahead of it ({min(spin_ms):.3f} ms), so the times hold '
             'host work')
    return {name: {'min': min(t), 'median': float(np.median(t))}
            for name, t in times.items()}


def fastest_pair(what, run, inputs):
    """Each of the two ``inputs`` (one segment, every tile masked) through
    ``run`` (:func:`fastest_calls`). Fails unless the unmasked batch is
    faster, where the kernel skips the mask. Returns ``{layout: {'min':
    ms, 'median': ms}}``."""
    times = fastest_calls(what, {name: (lambda x=x: run(x))
                                 for name, x in inputs.items()})
    a, b = (t['min'] for t in times.values())
    if not a < b:
        fail(f'{what} is not faster where every tile lies in one segment '
             f'({a:.4f} vs {b:.4f} ms): the mask is not skipped')
    return times


def time_mask_skip(T, H, D, dev):
    """Each pass of H2's Hopper form on the mask-skip pair
    (:func:`mask_skip_segs`, :func:`fastest_pair`). Returns ``{pass:
    {layout: {'min': ms, 'median': ms}}}``."""
    from esme_tpu_torch.ops import flash
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k, v, do = (randn((T, H * D), gen, dev) for _ in range(4))
    inputs = {}
    for name, seg in mask_skip_segs(T, dev).items():
        spans = flash.flash_spans(seg)
        o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
        inputs[name] = (q, k, v, do, lse, flash.attention_delta(o, do, H),
                        seg, *spans, H)
    times = {pname: fastest_pair(f'H2 {pname} pass at T={T}',
                                 lambda a: sm90_pass(which, a), inputs)
             for which, pname in ((0, 'dkv'), (1, 'dq'))}
    del inputs, q, k, v, do
    torch.cuda.empty_cache()
    return times


def time_fwd_mask_skip(T, H, D, dev):
    """H1's Hopper form on the mask-skip pair (:func:`mask_skip_segs`,
    :func:`fastest_pair`). Returns ``{layout: {'min': ms, 'median':
    ms}}``."""
    # the same seed: the same q, k and v over both segment layouts
    from esme_tpu_torch.ops import flash
    inputs = {name: seg_flash_args(seg, H, D, dev, 13)
              for name, seg in mask_skip_segs(T, dev).items()}
    times = fastest_pair(f'H1 (flash_fwd_sm90) at T={T}',
                         lambda a: flash.launch_fwd('flash_fwd_sm90', *a),
                         inputs)
    del inputs
    torch.cuda.empty_cache()
    return times


def mma_sync_bwd(args):
    """H2's mma.sync form (``csrc/flash_bwd.cu``), the mode-0 pair that H7
    ``real`` ablates, through its C entry (no counter moves)."""
    from esme_tpu_torch.ops import flash
    return flash.launch_bwd('flash_bwd', *args)


def sdpa_ms(q, k, v, seg, H, D, reps):
    """One ``scaled_dot_product_attention`` call over the whole packed
    batch with a block-diagonal boolean mask (memory-efficient backend;
    the math backend would need (H, T, T) scores). Yardstick only."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T = q.shape[0]
    qh, kh, vh = (x.view(T, H, D).transpose(0, 1)[None] for x in (q, k, v))
    mask = (seg[:, None] == seg[None, :])[None, None]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        def run():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)
        out = run()
        ms = cuda_ms(run, reps)
    o = out[0].transpose(0, 1).reshape(T, H * D)
    del mask, out
    return ms, o


def varlen_flash_ms(q, k, v, seg, H, D, reps):
    """One call of PyTorch's varlen flash-attention forward with the
    segments as ``cu_seqlens``: the same function, over same-segment
    tiles only (the dense-mask SDPA call does T^2 work). Yardstick
    only."""
    T = q.shape[0]
    counts = torch.unique_consecutive(seg, return_counts=True)[1]
    cu = torch.nn.functional.pad(counts.cumsum(0), (1, 0)).to(torch.int32)
    longest = int(counts.max())
    qh, kh, vh = (x.view(T, H, D) for x in (q, k, v))

    def run():
        return torch.ops.aten._flash_attention_forward(
            qh, kh, vh, cu, cu, longest, longest, 0.0, False, False,
            scale=D ** -0.5)[0]
    out = run()
    return cuda_ms(run, reps), out.reshape(T, H * D)


def varlen_flash_bwd_ms(q, k, v, do, seg, H, D, reps):
    """One call of PyTorch's varlen flash-attention backward with the
    segments as ``cu_seqlens``, on its own forward's output and lse.
    Yardstick only; returns its dq."""
    T = q.shape[0]
    counts = torch.unique_consecutive(seg, return_counts=True)[1]
    cu = torch.nn.functional.pad(counts.cumsum(0), (1, 0)).to(torch.int32)
    longest = int(counts.max())
    qh, kh, vh, doh = (x.view(T, H, D) for x in (q, k, v, do))
    out, lse, rng_state, unused, _ = torch.ops.aten._flash_attention_forward(
        qh, kh, vh, cu, cu, longest, longest, 0.0, False, False,
        scale=D ** -0.5)

    def run():
        return torch.ops.aten._flash_attention_backward(
            doh, qh, kh, vh, out, lse, cu, cu, longest, longest, 0.0, False,
            rng_state, unused, scale=D ** -0.5)[0]
    dq = run()
    return cuda_ms(run, reps), dq.reshape(T, H * D)


def yardstick(name, fn, ref, ref_name='H1'):
    """Milliseconds of a library call, or None if it did not run; logs
    its largest difference from the kernel's output ``ref``."""
    try:
        ms, out = fn()
    except RuntimeError as e:
        log(f'{name} did not run: {str(e).splitlines()[0][:200]}')
        return None
    log(f'{name} vs {ref_name}: max|diff| '
        f'{(out.float() - ref.float()).abs().max().item():.3e}')
    del out
    torch.cuda.empty_cache()
    return ms


# H9 (the rectangular forward): phase 3 checks every rank of the check
# batch at these world sizes, and a ragged split (rows [lo, hi), Tq % 128
# != 0); phase 10 times every rank of one world at the main shape.
RECT_WORLDS = (2, 4, 8)
RECT_RAGGED = (700, 1701)
RECT_TIMED_WORLD = 4


def rect_args(q, k, v, seg, lo, hi, H):
    """H9's arguments but ``seg_k`` (= ``seg``): the queries of rows
    ``[lo, hi)`` over all of ``k``, ``v`` and their spans."""
    from esme_tpu_torch.ops import flash
    sq = seg[lo:hi].contiguous()
    return (q[lo:hi].contiguous(), k, v, sq, *flash.rect_spans(sq, seg), H)


def check_rect(cu, dev):
    """Phase 3's H9 checks on the check batch: every rank of each world in
    ``RECT_WORLDS`` at D = 16, 24, 32, 64, 128 on H9's route (and on the
    mma.sync form's rectangular entry where the route is the Hopper form)
    under H1's gates; o and lse bit-equal to H1's rows on the whole batch
    where the rank's first row is a multiple of ``BLOCK_Q``; the ragged
    split ``RECT_RAGGED``; a q block whose ids match no key (an empty span)
    written as o = 0, lse = ``EMPTY_LSE`` on both routes. Returns the largest o
    and lse errors."""
    from esme_tpu_torch.ops import flash
    e_o = e_l = 0.0
    for d, h in ((16, 20), (24, 20), (32, 20), (64, 20), (128, 40)):
        q, k, v, seg, _, spans = flash_inputs(cu, CHECK_BUDGET, h, d, dev,
                                              seed=d + 100)
        T = q.shape[0]
        o_sq, lse_sq = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], h)
        forms = [None] if flash.fwd_route(d) == 'flash_fwd' \
            else [None, 'flash_fwd']
        equal = 0
        for n in RECT_WORLDS:
            for r in range(n):
                lo, hi = r * T // n, (r + 1) * T // n
                args = rect_args(q, k, v, seg, lo, hi, h)
                for lib in forms:
                    eo, el, o, lse = check_flash_args(
                        args, f' rank {r} of {n}', seg_k=seg, library=lib)
                    e_o, e_l = max(e_o, eo), max(e_l, el)
                    if lib is None and lo % flash.BLOCK_Q == 0:
                        if not (torch.equal(o, o_sq[lo:hi])
                                and torch.equal(lse, lse_sq[:, lo:hi])):
                            fail(f'H9 rank {r} of {n} at D={d}: o or lse not '
                                 'bit-equal to H1\'s rows on the whole batch')
                        equal += 1
        for lib in forms:
            eo, el, *_ = check_flash_args(
                rect_args(q, k, v, seg, *RECT_RAGGED, h),
                f' ragged rows {RECT_RAGGED}', seg_k=seg, library=lib)
            e_o, e_l = max(e_o, eo), max(e_l, el)
        log(f'H9 D={d}: {equal} aligned ranks bit-equal to H1\'s rows on the '
            f'whole batch (gate: bit equality) ok')
        if d in (16, 64):
            sq = seg[:1024].clone()
            sq[:flash.BLOCK_Q] += 10 ** 6
            ks, ke = flash.rect_spans(sq, seg)
            args = (q[:1024].contiguous(), k, v, sq, ks, ke, h)
            for lib in forms:
                *_, o, lse = check_flash_args(args, ' (empty span)',
                                              seg_k=seg, library=lib)
                if not (ke[0] <= ks[0] and not o[:flash.BLOCK_Q].any() and
                        bool((lse[:, :flash.BLOCK_Q] ==
                              flash.EMPTY_LSE).all())):
                    fail(f'H9 ({lib or flash.fwd_route(d)}) at D={d}: a q '
                         'block with an empty span is not o = 0, lse = '
                         'EMPTY_LSE')
        del q, k, v, o_sq, lse_sq
        torch.cuda.empty_cache()
    return e_o, e_l


def check_rect_ptxas():
    """H9's instantiations as built: each one's ``ptxas`` line logged; the
    Hopper form's at every head dim and the mma.sync form's at every
    padded width with no more stack and spills than H1's production
    kernel of the same form and width (``SM90_PRODUCTION``,
    ``MODE0_REGISTERS``: none; none at D = 16, 24); fail otherwise.
    Returns the usage."""
    from esme_tpu_torch import _build
    sm90 = sm90_ptxas_usage(_build.build_log('flash_fwd_sm90'),
                            'flash_fwd_rect')
    mma = ptxas_usage(_build.build_log('flash_fwd'))
    h1 = SM90_PRODUCTION[('flash_fwd_sm90', 'flash_fwd_sm90_kernel')]
    rows = [('flash_fwd_sm90', d, sm90.get(('flash_fwd_rect_sm90_kernel', d)),
             h1.get(d, (0, 0, 0, 0))) for d in (16, 24, 32, 64, 128)]
    rows += [('flash_fwd', d, mma.get(('flash_fwd_rect_kernel', d)),
              (0, 0, 0, 0)) for d in (16, 32, 64, 128)]
    for lib, d, got, want in rows:
        log(f'ptxas: {lib} H9 (rectangular) D={d}: {got and got[0]} '
            f'registers, (stack, spill stores, spill loads) '
            f'{got and got[1:]}; H1\'s production kernel: {want}')
        if got is None or any(a > b for a, b in zip(got[1:], want[1:])):
            fail(f'ptxas: H9\'s {lib} instantiation at D={d} has more stack '
                 f'or spills than H1\'s ({got} vs {want}), or is missing')
    return {lib: {str(d): got for name, d, got, _ in rows if name == lib}
            for lib in ('flash_fwd_sm90', 'flash_fwd')}


def rect_work(args, seg_k, H, D):
    """Bytes H9 must move and the operations its rows need, as this run's
    ids decide them: q read and o written (Tq rows), the rows of k and v
    whose ids some query carries read once (the rest of the gathered stream
    is not needed), lse written, those rows' ids, the queries' ids and the
    spans read; 2·2·D flops per (query row, same-segment key) pair and head
    (QKᵀ and PV)."""
    q, _, _, sq, ks, _, _ = args
    Tq, HD = q.shape
    keys = torch.bincount(seg_k.long())
    needed = int(keys[torch.unique(sq).long()].sum().item())
    nbytes = 2 * Tq * HD * 2 + 2 * needed * HD * 2 + H * Tq * 4 \
        + (Tq + needed) * 4 + 2 * ks.numel() * 4
    flops = 4.0 * D * H * float(keys[sq.long()].double().sum().item())
    return nbytes, flops


def varlen_rect_ms(args, seg_k, H, D, reps):
    """One call of PyTorch's varlen flash-attention forward over a rank's
    queries: ``cu_seqlens_q`` over the rank's piece of each segment it
    touches, ``cu_seqlens_k`` over those segments whole (monotonic ids).
    Yardstick only; returns its o ``(Tq, H·D)``."""
    q, k, v, sq = args[:4]
    Tq = q.shape[0]
    ids, qc = torch.unique_consecutive(sq, return_counts=True)
    kc = torch.bincount(seg_k.long())[ids.long()]
    k0 = int(torch.searchsorted(seg_k, ids[:1]).item())
    k1 = k0 + int(kc.sum().item())
    cu_q = torch.nn.functional.pad(qc.cumsum(0), (1, 0)).to(torch.int32)
    cu_k = torch.nn.functional.pad(kc.cumsum(0), (1, 0)).to(torch.int32)
    qh = q.view(Tq, H, D)
    kh, vh = (x[k0:k1].view(k1 - k0, H, D) for x in (k, v))
    mq, mk = int(qc.max()), int(kc.max())

    def run():
        return torch.ops.aten._flash_attention_forward(
            qh, kh, vh, cu_q, cu_k, mq, mk, 0.0, False, False,
            scale=D ** -0.5)[0]
    out = run()
    return cuda_ms(run, reps), out.reshape(Tq, H * D)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def check_cp(dev, batch, phase4_ms):
    """Phase 10, the context-parallel path: a one-rank world (NCCL on the
    card) on 127.0.0.1 and its ``seq`` mesh; ESM2 at ``MODEL`` (bf16,
    seed-0 weights, as phase 4 builds it) through
    ``context_parallel_log_prob`` on the main batch with the launch
    counters set to 0 just before and read just after (H9 and H3 once per
    layer, nothing else); the log-probs finite normalised rows, against
    the same model's ``predict_log_prob`` under phase 4's gate and
    bit-equal to them (a world of one); its time
    (CUDA events after a warm-up), real tokens/s and peak memory beside
    phase 4's. The process group is destroyed at the end."""
    import torch.distributed as dist
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import (context_parallel_log_prob,
                                         initialize_distributed, make_mesh)
    tokens, cu, max_len = batch
    real = int(cu[-1])
    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0,
                           device=dev.type)
    try:
        mesh = make_mesh(seq=1, device=dev.type)
        log(f'context parallel: {dist.get_backend()} world of '
            f'{dist.get_world_size()}, mesh {mesh}')
        model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
        L = model.config.num_layers

        def run():
            return context_parallel_log_prob(model, tokens, (cu, max_len),
                                             mesh)
        reset_counters()
        lp = run()
        torch.cuda.synchronize()
        launches = read_counters()
        log(f'context-parallel path launches per forward: {launches}')
        expect_launches('context-parallel path', launches,
                        **{H9_NAME: L, H3_NAME: L})
        V = model.config.vocab_size
        if tuple(lp.shape) != (len(tokens), V) or lp.dtype != torch.float32:
            fail(f'context-parallel log-probs have shape '
                 f'{tuple(lp.shape)} {lp.dtype}')
        lse_err = lp[:real].logsumexp(-1).abs().max().item()
        finite = bool(torch.isfinite(lp).all())
        log(f'context-parallel path: log-probs finite {finite}, '
            f'max|logsumexp| {lse_err:.2e} (gate {LOGSUMEXP_ATOL})')
        if not finite or lse_err > LOGSUMEXP_ATOL:
            fail('context-parallel log-probs are not finite normalised rows')
        ref = model.predict_log_prob(tokens, pad_args=(cu, max_len))
        check = compare_logp(lp[:real], ref[:real],
                             f'context-parallel path ({L} layers, {real} '
                             f'tokens) vs predict_log_prob')
        # one rank: H9 walks H1's spans over the same rows, and the pad rows
        # of predict_log_prob touch no real row
        same = torch.equal(lp[:real], ref[:real])
        log(f'context-parallel path: log-probs bit-equal to '
            f'predict_log_prob\'s in a world of one {same} '
            f'{"ok" if same else "FAIL"}')
        if not same:
            fail('a one-rank context-parallel forward is not bit-equal to '
                 'predict_log_prob')
        check['bit_equal'] = same
        del lp, ref
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        samples = [cuda_ms(run, reps=1, warmup=int(i == 0))
                   for i in range(FWD_REPS)]
        peak = torch.cuda.max_memory_allocated()
        ms = float(np.median(samples))
        log(f'context-parallel path: median {ms:.2f} ms per batch of '
            f'{FWD_REPS} (min {min(samples):.2f}, max {max(samples):.2f}), '
            f'{real / ms * 1e3:.1f} real tokens/s, peak memory '
            f'{peak / 2**30:.2f} GiB; predict_log_prob (phase 4) '
            f'{phase4_ms:.2f} ms ({ms / phase4_ms:.4f})')
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {'launches': launches, 'vs_predict_log_prob': check,
            'ms_per_batch': ms, 'ms_per_batch_samples': samples,
            'real_tokens_per_s': real / ms * 1e3,
            'peak_mem_gib': peak / 2**30, 'phase4_ms_per_batch': phase4_ms}


def time_rect(cu, dev, H=None, D=None, T=None, n=None, mask_skip=True):
    """H9's times at the main inference shape (H = 20, D = 64, or ``H``
    heads of ``D``) for each rank of an ``n``-rank world over the T tokens
    of the batch ``cu`` (the split ``forward_flat_cp`` makes, T / n query
    rows over all T keys): the kernel, its mma.sync form through its
    rectangular entry, its plain version, the bound of the rank's work
    and, as a yardstick only, PyTorch's varlen forward over the rank's
    pieces of its segments; with ``mask_skip``, the Hopper form on rank 0
    on the mask-skip pair. Each rank's inputs
    are held first against the plain version under H1's gates, on H9's
    route and on the mma.sync form (``check_flash_args``), and so is the
    one-rank shape that phase 10's path gives H9 (Tq = Tk = T, no ALIGN
    pad, a ragged last block). Returns the kernels line's row (times
    summed over the ranks, the largest errors of those checks) without
    launches."""
    from esme_tpu_torch.models.esm import packed_meta
    from esme_tpu_torch.ops import flash
    H = H or MODEL['attention_heads']
    D = D or MODEL['embed_dim'] // H
    T, n = T or BUDGET, n or RECT_TIMED_WORLD
    seg = packed_meta(torch.as_tensor(cu, device=dev), T)[0].contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q, k, v = (randn((T, H * D), gen, dev) for _ in range(3))
    ranks = []
    e_o, e_l, o, _ = check_flash_args(rect_args(q, k, v, seg, 0, T, H),
                                      ' one rank of 1 at the main shape',
                                      seg_k=seg)
    del o
    for r in range(n):
        lo, hi = r * T // n, (r + 1) * T // n
        args = rect_args(q, k, v, seg, lo, hi, H)
        what = f' rank {r} of {n} at the main shape'
        eo, el, *_ = check_flash_args(args, what, seg_k=seg,
                                      library='flash_fwd')
        e_o, e_l = max(e_o, eo), max(e_l, el)
        eo, el, o, _ = check_flash_args(args, what, seg_k=seg)
        e_o, e_l = max(e_o, eo), max(e_l, el)
        ms = cuda_ms(lambda: flash.segment_flash_fwd(*args, seg_k=seg),
                     reps=20, warmup=2)
        mma_ms = cuda_ms(lambda: flash.launch_fwd('flash_fwd', *args,
                                                  seg_k=seg),
                         reps=20, warmup=2)
        plain_ms = cuda_ms(lambda: flash.segment_flash_fwd_plain(
            *args, seg_k=seg), reps=2)
        nbytes, flops = rect_work(args, seg, H, D)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        lib_ms = yardstick(f'varlen flash-attention forward (aten), rank {r} '
                           f'of {n}', lambda: varlen_rect_ms(args, seg, H, D,
                                                             reps=20), o, 'H9')
        ranks.append({'rows': [lo, hi], 'ms': ms, 'mma_sync_form_ms': mma_ms,
                      'plain_ms': plain_ms, 'bound_ms': b_ms,
                      'bound_by': b_by, 'library_varlen_ms': lib_ms,
                      'bytes': nbytes, 'flops': flops})
        log(f'H9 rank {r} of {n} (rows {lo}-{hi} over {T} keys, H={H} '
            f'D={D}): {ms:.4f} ms ({flash.fwd_route(D)}), the mma.sync form '
            f'{mma_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms '
            f'by {b_by} ({b_ms / ms:.3f} of it), varlen library {lib_ms}')
        del o
    skip = None
    if mask_skip:
        sk = {name: sseg for name, sseg in mask_skip_segs(T, dev).items()}
        inputs = {name: (rect_args(q, k, v, sseg, 0, T // n, H), sseg)
                  for name, sseg in sk.items()}
        skip = fastest_pair(f'H9 (flash_fwd_sm90) rank 0 of {n} at T={T}',
                            lambda a: flash.launch_fwd('flash_fwd_sm90',
                                                       *a[0], seg_k=a[1]),
                            inputs)
        del inputs
    del q, k, v
    torch.cuda.empty_cache()
    total = {key: sum(rk[key] for rk in ranks)
             for key in ('ms', 'mma_sync_form_ms', 'plain_ms', 'bound_ms',
                         'bytes', 'flops')}
    libs = [rk['library_varlen_ms'] for rk in ranks]
    lib = sum(libs) if None not in libs else None
    by = bound(total['bytes'], total['flops'], BF16_FLOP_PER_S)[1]
    log(f'H9 over the {n} ranks: {total["ms"]:.4f} ms, bound '
        f'{total["bound_ms"]:.4f} ms by {by}, plain {total["plain_ms"]:.3f} '
        f'ms, varlen library {lib}')
    return {'name': H9_NAME, 'route': 'cuda',
            'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
            'routes': {str(d): f'esme_tpu_torch/csrc/{flash.fwd_route(d)}.cu'
                       for d in flash.HEAD_DIMS},
            'replaces': 'esme_tpu/ops/flash.py:1168',
            'also_replaces': ['esme_tpu/ops/flash.py:459'],
            'max_abs_err': e_o, 'lse_max_abs_err': e_l,
            'ms': total['ms'], 'plain_ms': total['plain_ms'],
            'bound_ms': total['bound_ms'], 'bound_by': by,
            'library_ms': lib, 'library_varlen_ms': lib,
            'mma_sync_form_ms': total['mma_sync_form_ms'],
            'mask_skip_ms': skip, 'ranks': ranks,
            'shape': f'T={T} H={H} D={D} bf16: {n} ranks of {T // n} query '
                     f'rows over all {T} keys, times summed over the ranks',
            'bytes': total['bytes'], 'flops': total['flops']}


# H10 (the rectangular backward): phase 3 checks one rank and every rank
# of RECT_WORLDS on the check batch; phase 11 runs it on the one-rank path
# and times every rank of a RECT_TIMED_WORLD split of the 50k train batch.
RECT_BWD_WORLDS = (1, *RECT_WORLDS)
# Phase 11's timed steps after its warm-up: a fresh Adam's first updates
# (lr·sign(g) on every leaf) raise the loss before it falls (phase 5's
# cells: the 10k cell's six losses fall by the fifth), so six steps in
# all, and the last loss must be below the first
CP_TRAIN_STEPS = 5
# Phase 11 then steps ShardedMaskedPLM and MaskedPLM from the same fresh
# weights on the same batch. Each step's loss must agree to 2^-8 of it:
# below half the smallest step-to-step change of these losses on the H100
# (3.687 -> 3.721, 0.034), so the two take the same steps.
CP_COMPARE_STEPS = 3
CP_LOSS_REL = 2 ** -8
# The params after the first update, per leaf (compare_updates): Adam's
# first step moves an element by at most lr, so gradients that differ only
# in rounding (phase 5's gates) can move it 2·lr apart at most, where the
# sign of a near-zero gradient flips, plus one bf16 rounding of each side
# (2^-7 of the element) and 2^-7 of lr for the update's own rounding; and
# the summed |difference of the two updates| within 2^-4 of the summed
# |update| (a lost update gives 1, a doubled or negated one 1 or 2).
UPDATE_ROUND = 2 ** -7
UPDATE_MASS_REL = 2 ** -4


def rect_bwd_args(q, k, v, do, seg, lo, hi, H):
    """H10's arguments but ``seg_k`` (= ``seg``): the queries and output
    gradients of rows ``[lo, hi)`` over all of ``k`` and ``v``, H9's lse
    (on its route), delta and H10's spans."""
    from esme_tpu_torch.ops import flash
    sq = seg[lo:hi].contiguous()
    spans = flash.rect_flash_spans(sq, seg)
    qr, dor = q[lo:hi].contiguous(), do[lo:hi].contiguous()
    o, lse = flash.segment_flash_fwd(qr, k, v, sq, *spans[:2], H, seg_k=seg)
    return (qr, k, v, dor, lse, flash.attention_delta(o, dor, H), sq,
            *spans, H)


def rect_grad_errors(got, ref, touched):
    """H10's outputs against its plain version: dq under H2's gate as
    :func:`grad_errors` takes it; dk and dv under it on the key rows
    ``touched`` (those whose ids a query carries; the gate's rms over
    them), and exactly 0 elsewhere. Returns (errors, gate shares, finite
    and the zero rows zero)."""
    errs, shares, ok = grad_errors(got[:1], ref[:1])
    errs, shares = list(errs), list(shares)
    e, sh, fin = grad_errors([g[touched] for g in got[1:]],
                             [r[touched] for r in ref[1:]])
    zero = all(not g[~touched].any() for g in got[1:])
    return errs + e, shares + sh, ok and fin and zero


def check_rect_bwd_args(args, seg_k, what='', library=None):
    """H10 (on its route, or through ``library``'s rectangular entry) vs
    its plain version on ``segment_flash_bwd``'s arguments with
    ``seg_k``, under H2's gate (:func:`rect_grad_errors`), and bit-equal
    across two calls. Returns (largest error, largest gate share, dq, dk,
    dv)."""
    from esme_tpu_torch.ops import flash
    q, *_, H = args
    D = q.shape[1] // H
    form = library or flash.bwd_route(D)

    def run():
        if library is None:
            return flash.segment_flash_bwd(*args, seg_k=seg_k)
        return flash.launch_bwd(library, *args, seg_k=seg_k)
    got = run()
    again = run()
    ref = flash.segment_flash_bwd_plain(*args, seg_k=seg_k)
    torch.cuda.synchronize()
    touched = torch.isin(seg_k, args[6])
    errs, shares, ok = rect_grad_errors(got, ref, touched)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = ok and max(shares) <= 1.0 and same
    log(f'H10{what} Tq={q.shape[0]} Tk={seg_k.shape[0]} H={H} D={D} '
        f'({form}): max|g-plain| dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/'
        f'{errs[2]:.3e}, largest share of the gate (2^-4*max(|g|, rms g); '
        f'dk, dv on the {int(touched.sum())} key rows the queries touch, 0 '
        f'on the rest) {shares[0]:.3f}/{shares[1]:.3f}/{shares[2]:.3f}, '
        f'bit-equal across two calls {same} {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'H10 ({form}) disagrees with its plain version (or itself) '
             f'at Tq={q.shape[0]} D={D}{what}')
    return max(errs), max(shares), *got


def check_rect_bwd(cu, dev):
    """Phase 3's H10 checks on the check batch: one rank and every rank of
    each world in ``RECT_WORLDS`` at D = 16, 24, 32, 64, 128 on H10's route
    and, where the route is the Hopper form, on the mma.sync form's
    rectangular entry too (:func:`check_rect_bwd_args`); on each form, dq
    bit-equal to that form's H2 rows on the whole batch where the rank's
    first row is a multiple of ``BLOCK_Q``, every output bit-equal to it
    with one rank, and dk, dv summed over the ranks under H2's gate against
    it; the ragged split ``RECT_RAGGED``; a q block whose ids match no key
    (dq = 0 there) and key blocks no query shares an id with (dk = dv = 0).
    Returns the largest error and gate share."""
    from esme_tpu_torch.ops import flash
    e_max = share_max = 0.0
    for d, h in ((16, 20), (24, 20), (32, 20), (64, 20), (128, 40)):
        q, k, v, do, lse, delta, seg, spans = bwd_inputs(
            cu, CHECK_BUDGET, h, d, dev, seed=d + 200)
        T = q.shape[0]
        forms = [None] if flash.bwd_route(d) == 'flash_bwd' \
            else [None, 'flash_bwd']
        square = {lib: flash.launch_bwd(lib or flash.bwd_route(d), q, k, v,
                                        do, lse, delta, seg, *spans, h)
                  for lib in forms}
        equal = 0
        for n in RECT_BWD_WORLDS:
            sums = {lib: [torch.zeros_like(k, dtype=torch.float32)
                          for _ in range(2)] for lib in forms}
            for r in range(n):
                lo, hi = r * T // n, (r + 1) * T // n
                args = rect_bwd_args(q, k, v, do, seg, lo, hi, h)
                for lib in forms:
                    e, share, dq, dk, dv = check_rect_bwd_args(
                        args, seg, f' rank {r} of {n}', lib)
                    e_max, share_max = max(e_max, e), max(share_max, share)
                    sums[lib][0] += dk.float()
                    sums[lib][1] += dv.float()
                    sq_dq, sq_dk, sq_dv = square[lib]
                    name = lib or flash.bwd_route(d)
                    if lo % flash.BLOCK_Q == 0:
                        if not torch.equal(dq, sq_dq[lo:hi]):
                            fail(f'H10 ({name}) rank {r} of {n} at D={d}: dq '
                                 'not bit-equal to H2\'s rows on the whole '
                                 'batch')
                        equal += 1
                    if n == 1 and not (torch.equal(dk, sq_dk)
                                       and torch.equal(dv, sq_dv)):
                        fail(f'H10 ({name}) with one rank at D={d}: dk or '
                             'dv not bit-equal to H2\'s')
            for lib in forms:
                errs, shares, finite = grad_errors(sums[lib], square[lib][1:])
                log(f'H10 ({lib or flash.bwd_route(d)}) D={d}: dk/dv summed '
                    f'over the {n} ranks vs H2 on the whole batch: max|diff| '
                    f'{errs[0]:.3e}/{errs[1]:.3e}, largest share of H2\'s gate '
                    f'{shares[0]:.3f}/{shares[1]:.3f}')
                if max(shares) > 1.0 or not finite:
                    fail(f'H10 at D={d}: dk, dv summed over {n} ranks out of '
                         'H2\'s gate against H2')
        for lib in forms:
            e, share, *_ = check_rect_bwd_args(
                rect_bwd_args(q, k, v, do, seg, *RECT_RAGGED, h), seg,
                f' ragged rows {RECT_RAGGED}', lib)
            e_max, share_max = max(e_max, e), max(share_max, share)
        log(f'H10 D={d}: {equal} aligned ranks\' dq and the one-rank '
            f'outputs bit-equal to H2\'s (gate: bit equality) ok')
        if d in (16, 64):
            sq = seg[:1024].clone()
            sq[:flash.BLOCK_Q] += 10 ** 6
            ks, ke, qs, qe = flash.rect_flash_spans(sq, seg)
            o, lse_r = flash.segment_flash_fwd(q[:1024].contiguous(), k, v, sq,
                                               ks, ke, h, seg_k=seg)
            dor = do[:1024].contiguous()
            args = (q[:1024].contiguous(), k, v, dor, lse_r,
                    flash.attention_delta(o, dor, h), sq, ks, ke, qs, qe, h)
            empty = (qe <= qs).repeat_interleave(flash.BLOCK_KV)[:T]
            for lib in forms:
                *_, dq, dk, dv = check_rect_bwd_args(args, seg, ' (empty span)',
                                                     lib)
                if not (ke[0] <= ks[0] and bool(empty.any())
                        and not dq[:flash.BLOCK_Q].any()
                        and not dk[empty].any() and not dv[empty].any()):
                    fail(f'H10 ({lib or flash.bwd_route(d)}) at D={d}: an '
                         'empty span does not give dq = 0, or key blocks no '
                         'query touches not dk = dv = 0')
        del q, k, v, do, square
        torch.cuda.empty_cache()
    return e_max, share_max


def check_rect_bwd_ptxas():
    """H10's instantiations as built: each one's ``ptxas`` line logged; the
    Hopper form's at every head dim and the mma.sync form's at every padded
    width with no more stack and spills than H2's production pass of the
    same form and width (``SM90_PRODUCTION``: H2's dk/dv pass spills at
    D = 128; ``MODE0_REGISTERS``: none; none at D = 16, 24); fail
    otherwise. Returns the usage."""
    from esme_tpu_torch import _build
    sm90 = sm90_ptxas_usage(_build.build_log('flash_bwd_sm90'),
                            r'bwd_(?:dkv|dq)_rect')
    mma = ptxas_usage(_build.build_log('flash_bwd'))
    rows = []
    for p in ('dkv', 'dq'):
        kernel = f'bwd_{p}_rect_sm90_kernel'
        h2 = SM90_PRODUCTION[('flash_bwd_sm90', f'bwd_{p}_sm90_kernel')]
        for d in (16, 24, 32, 64, 128):
            keys = sorted(key for key in sm90 if key[:2] == (kernel, d))
            if len(keys) != 1:
                fail(f'ptxas: H10\'s {kernel} at D={d}: {len(keys)} '
                     f'instantiations built, not 1')
            rows += [('flash_bwd_sm90', key, sm90[key],
                      h2.get(d, (0, 0, 0, 0))) for key in keys]
    for kernel in ('flash_bwd_dkv_rect_kernel', 'flash_bwd_dq_rect_kernel'):
        rows += [('flash_bwd', (kernel, d), mma.get((kernel, d)),
                  (0, 0, 0, 0)) for d in (16, 32, 64, 128)]
    for lib, key, got, want in rows:
        log(f'ptxas: {lib} H10 {key[0]}<{", ".join(map(str, key[1:]))}>: '
            f'{got and got[0]} registers, (stack, spill stores, spill loads) '
            f'{got and got[1:]}; H2\'s production pass: {want}')
        if got is None or any(a > b for a, b in zip(got[1:], want[1:])):
            fail(f'ptxas: H10\'s {lib} instantiation {key} has more stack or '
                 f'spills than H2\'s ({got} vs {want}), or is missing')
    return {lib: {' '.join(map(str, key)): got
                  for name, key, got, _ in rows if name == lib}
            for lib in ('flash_bwd_sm90', 'flash_bwd')}


def rect_bwd_work(args, seg_k, H, D):
    """Bytes H10 must move and the operations its rows need, as this run's
    ids decide them: q and do read and dq written (Tq rows), the rows of k
    and v whose ids some query carries read once, dk and dv written over
    all Tk rows (the rows no query touches as zeros), lse and delta read,
    those rows' ids, the queries' ids and the spans read; five products
    of 2·D flops per (query row, same-segment key) pair and head (S, dP,
    dV, dK, dQ), as H2's row counts them."""
    q, k, *_, sq, ks, ke, qs, qe, _ = args
    Tq, HD = q.shape
    Tk = k.shape[0]
    keys = torch.bincount(seg_k.long())
    needed = int(keys[torch.unique(sq).long()].sum().item())
    nbytes = 3 * Tq * HD * 2 + 2 * needed * HD * 2 + 2 * Tk * HD * 2 \
        + 2 * H * Tq * 4 + (Tq + needed) * 4 \
        + sum(x.numel() for x in (ks, ke, qs, qe)) * 4
    flops = 10.0 * D * H * float(keys[sq.long()].double().sum().item())
    return nbytes, flops


def varlen_rect_bwd_ms(args, seg_k, H, D, reps):
    """One call of PyTorch's varlen flash-attention backward over a rank's
    queries (``cu_seqlens_q`` over the rank's piece of each segment it
    touches, ``cu_seqlens_k`` over those segments whole), on its own
    forward's output and lse. Yardstick only; returns its dq ``(Tq,
    H·D)``."""
    q, k, v, do, _, _, sq = args[:7]
    Tq = q.shape[0]
    ids, qc = torch.unique_consecutive(sq, return_counts=True)
    kc = torch.bincount(seg_k.long())[ids.long()]
    k0 = int(torch.searchsorted(seg_k, ids[:1]).item())
    k1 = k0 + int(kc.sum().item())
    cu_q = torch.nn.functional.pad(qc.cumsum(0), (1, 0)).to(torch.int32)
    cu_k = torch.nn.functional.pad(kc.cumsum(0), (1, 0)).to(torch.int32)
    qh, doh = q.view(Tq, H, D), do.view(Tq, H, D)
    kh, vh = (x[k0:k1].view(k1 - k0, H, D) for x in (k, v))
    mq, mk = int(qc.max()), int(kc.max())
    out, lse, rng_state, unused, _ = torch.ops.aten._flash_attention_forward(
        qh, kh, vh, cu_q, cu_k, mq, mk, 0.0, False, False, scale=D ** -0.5)

    def run():
        return torch.ops.aten._flash_attention_backward(
            doh, qh, kh, vh, out, lse, cu_q, cu_k, mq, mk, 0.0, False,
            rng_state, unused, scale=D ** -0.5)[0]
    dq = run()
    return cuda_ms(run, reps), dq.reshape(Tq, H * D)


def rect_bwd_pass(which, args, seg_k):
    """One pass of H10's Hopper form alone, through its C entry
    ``esme_flash_bwd_rect_sm90_pass`` (no counter moves): ``which`` 0
    writes dk and dv, 1 writes dq."""
    from esme_tpu_torch import _build
    from esme_tpu_torch.ops import flash
    q, k, *_, H = args
    Tq, HD = q.shape
    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(k)]
    lib = _build.library('flash_bwd_sm90')
    entry = 'esme_flash_bwd_rect_sm90_pass'
    rc = getattr(lib, entry)(
        which, *(x.data_ptr() for x in (*args[:6], args[6], seg_k,
                                              *args[7:11], *outs)),
        Tq, k.shape[0], H, HD // H, 1.0 / math.sqrt(HD // H),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, lib, flash.BWD_ROUTES['flash_bwd_sm90'][1], entry)
    return outs


def time_rect_bwd(dev, H=None, D=None, T=None, n=None):
    """H10's times at the train shape (H = 20, D = 64, or ``H`` heads of
    ``D``) for each rank of an ``n``-rank split of the train batch of T
    tokens (bench.py's recipe, seed 2; T / n query rows over all T keys,
    no ALIGN pad, as ``ShardedMaskedPLM`` splits it): the kernel, its mma.sync form through
    its rectangular entry, each pass of the Hopper form alone, its plain
    version, the bound of the
    rank's work and, as a yardstick only, PyTorch's varlen backward over
    the rank's pieces of its segments; H2 on the whole batch in the same
    call. Each rank's inputs are held first against the plain version under
    H2's gate on both forms, and so is the one-rank shape of phase 11's
    path (Tq = Tk = T). Returns the kernels line's row (times summed over
    the ranks, the largest errors of those checks) without launches."""
    from esme_tpu_torch.models.esm import packed_meta
    from esme_tpu_torch.ops import flash
    H = H or MODEL['attention_heads']
    D = D or MODEL['embed_dim'] // H
    T, n = T or BUDGET, n or RECT_TIMED_WORLD
    _, tcu, _ = packed_batch(T, seed=2)
    seg = packed_meta(torch.as_tensor(tcu, device=dev), T)[0].contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    q, k, v, do = (randn((T, H * D), gen, dev) for _ in range(4))
    e_max, share_max, *_ = check_rect_bwd_args(
        rect_bwd_args(q, k, v, do, seg, 0, T, H), seg,
        ' one rank of 1 at the train shape')
    torch.cuda.empty_cache()
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    h2_args = (q, k, v, do, lse, flash.attention_delta(o, do, H), seg,
               *spans, H)
    h2_ms = cuda_ms(lambda: flash.segment_flash_bwd(*h2_args), reps=20,
                    warmup=2)
    del o, lse, h2_args
    ranks = []
    for r in range(n):
        lo, hi = r * T // n, (r + 1) * T // n
        args = rect_bwd_args(q, k, v, do, seg, lo, hi, H)
        what = f' rank {r} of {n} at the train shape'
        for lib in ('flash_bwd', None):
            e, share, dq, *_ = check_rect_bwd_args(args, seg, what, lib)
            e_max, share_max = max(e_max, e), max(share_max, share)
        ms = cuda_ms(lambda: flash.segment_flash_bwd(*args, seg_k=seg),
                     reps=20, warmup=2)
        mma_ms = cuda_ms(lambda: flash.launch_bwd('flash_bwd', *args,
                                                  seg_k=seg),
                         reps=20, warmup=2)
        passes = {name: cuda_ms(lambda: rect_bwd_pass(which, args, seg),
                                reps=20, warmup=2)
                  for name, which in (('dkv', 0), ('dq', 1))}
        plain_ms = cuda_ms(lambda: flash.segment_flash_bwd_plain(
            *args, seg_k=seg), reps=2)
        nbytes, flops = rect_bwd_work(args, seg, H, D)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        lib_ms = yardstick(f'varlen flash-attention backward (aten), rank {r} '
                           f'of {n}', lambda: varlen_rect_bwd_ms(
                               args, seg, H, D, reps=20), dq, 'H10 dq')
        empty = int((args[10] <= args[9]).sum())
        ranks.append({'rows': [lo, hi], 'ms': ms, 'mma_sync_form_ms': mma_ms,
                      'passes_ms': passes, 'plain_ms': plain_ms,
                      'bound_ms': b_ms, 'bound_by': b_by,
                      'library_varlen_ms': lib_ms, 'bytes': nbytes,
                      'flops': flops, 'empty_kv_blocks': empty,
                      'kv_blocks': int(args[9].numel())})
        log(f'H10 rank {r} of {n} (rows {lo}-{hi} over {T} keys, H={H} '
            f'D={D}): {ms:.4f} ms ({flash.bwd_route(D)}), passes {passes}, '
            f'the mma.sync form {mma_ms:.4f} ms, plain {plain_ms:.3f} ms, '
            f'bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.3f} of it), varlen '
            f'library {lib_ms}; {empty} of {args[9].numel()} 64-row key '
            f'blocks with an empty span')
        del args, dq
        torch.cuda.empty_cache()
    del q, k, v, do
    torch.cuda.empty_cache()
    total = {key: sum(rk[key] for rk in ranks)
             for key in ('ms', 'mma_sync_form_ms', 'plain_ms', 'bound_ms',
                         'bytes', 'flops')}
    passes = {name: sum(rk['passes_ms'][name] for rk in ranks)
              for name in ranks[0]['passes_ms']}
    libs = [rk['library_varlen_ms'] for rk in ranks]
    lib = sum(libs) if None not in libs else None
    by = bound(total['bytes'], total['flops'], BF16_FLOP_PER_S)[1]
    ratio = total['ms'] / h2_ms
    log(f'H10 over the {n} ranks: {total["ms"]:.4f} ms ({ratio:.4f} of H2 '
        f'on the whole batch, {h2_ms:.4f} ms), passes {passes}, '
        f'bound {total["bound_ms"]:.4f} ms by {by}, plain '
        f'{total["plain_ms"]:.3f} ms, varlen library {lib}')
    return {'name': H10_NAME, 'route': 'cuda',
            'source': 'esme_tpu_torch/csrc/flash_bwd_sm90.cu',
            'routes': {str(d): f'esme_tpu_torch/csrc/{flash.bwd_route(d)}.cu'
                       for d in flash.HEAD_DIMS},
            'replaces': 'esme_tpu/ops/flash.py:1083',
            'also_replaces': ['esme_tpu/ops/flash.py:807',
                              'esme_tpu/ops/flash.py:855'],
            'max_abs_err': e_max, 'gate_share': share_max,
            'ms': total['ms'], 'plain_ms': total['plain_ms'],
            'bound_ms': total['bound_ms'], 'bound_by': by,
            'library_ms': lib, 'library_varlen_ms': lib,
            'mma_sync_form_ms': total['mma_sync_form_ms'],
            'passes_ms': passes, 'h2_whole_batch_ms': h2_ms, 'ranks': ranks,
            'shape': f'T={T} H={H} D={D} bf16 (train batch): {n} ranks of '
                     f'{T // n} query rows over all {T} keys, times summed '
                     'over the ranks',
            'bytes': total['bytes'], 'flops': total['flops']}


def compare_updates(got, ref, before, lr, what):
    """Each leaf of ``got`` and ``ref`` (params after one Adam step from
    ``before`` at learning rate ``lr``) within ``UPDATE_ROUND``'s
    elementwise bound and ``UPDATE_MASS_REL``'s bound on the updates'
    difference; fails otherwise. Returns the bit-equal leaves, the count
    of elements that differ, the largest difference and the largest
    update-mass ratio."""
    out = {'leaves': 0, 'bit_equal': 0, 'elements_differ': 0,
           'max_abs': 0.0, 'max_mass_ratio': 0.0}
    for path, a, b in _leaf_pairs(got, ref):
        a = a.to(b.device)
        p0 = _leaf_at(before, path)
        a32, b32, p32 = a.float(), b.float(), p0.float()
        diff = (a32 - b32).abs()
        limit = 2 * lr * (1 + UPDATE_ROUND) \
            + UPDATE_ROUND * torch.maximum(a32.abs(), b32.abs())
        mass = (b32 - p32).abs().sum().item()
        moved = diff.sum().item()
        ratio = moved / mass if mass else (0.0 if moved == 0 else math.inf)
        out['leaves'] += 1
        out['bit_equal'] += bool(torch.equal(a, b))
        out['elements_differ'] += int((a != b).sum().item())
        out['max_abs'] = max(out['max_abs'], diff.max().item())
        out['max_mass_ratio'] = max(out['max_mass_ratio'], ratio)
        if not bool((diff <= limit).all()) or not ratio <= UPDATE_MASS_REL:
            fail(f'{what}: leaf {path} after one update: max |delta| '
                 f'{diff.max().item():.3e} (over 2·lr + {UPDATE_ROUND}·|p| '
                 f'in {int((diff > limit).sum().item())} elements), the '
                 f'updates\' difference {ratio:.4f} of the update (gate '
                 f'{UPDATE_MASS_REL})')
    return out


def _leaf_at(tree, path):
    for k in path.split('.'):
        tree = tree[k]
    return tree


def check_cp_steps(model, mesh, batch, lr, dev):
    """``ShardedMaskedPLM(seq_axis='seq')`` and ``MaskedPLM`` from the
    same weights (``model``'s, which the sharded trainer copies and
    ``MaskedPLM`` then updates in place) for ``CP_COMPARE_STEPS`` steps on
    ``batch``: each step's loss within ``CP_LOSS_REL`` of MaskedPLM's, the
    params after the first update under :func:`compare_updates`."""
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}
    before = clone(model.params)
    plm = ShardedMaskedPLM(model, mesh, learning_rate=lr, seq_axis='seq')
    losses = [plm.training_step([batch])]
    after = plm.unsharded_params()
    losses += [plm.training_step([batch])
               for _ in range(CP_COMPARE_STEPS - 1)]
    del plm
    torch.cuda.empty_cache()
    ref = MaskedPLM(model, learning_rate=lr)
    ref_losses = [ref.training_step(batch)]
    what = 'context-parallel training: ShardedMaskedPLM vs MaskedPLM'
    check = compare_updates(after, model.params, before, lr, what)
    ref_losses += [ref.training_step(batch)
                   for _ in range(CP_COMPARE_STEPS - 1)]
    del ref, after, before
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    check.update(losses=losses, losses_masked_plm=ref_losses,
                 loss_rel=rel)
    log(f'{what}, {CP_COMPARE_STEPS} steps from the same weights: losses '
        f'{losses} vs {ref_losses} (relative {[f"{x:.2e}" for x in rel]}, '
        f'gate {CP_LOSS_REL}); after the first update {check["bit_equal"]} '
        f'of {check["leaves"]} leaves bit-equal, {check["elements_differ"]} '
        f'elements differ, max |delta| {check["max_abs"]:.3e}, the updates\' '
        f'difference at most {check["max_mass_ratio"]:.3e} of the update')
    if not all(np.isfinite(losses)) or max(rel) > CP_LOSS_REL:
        fail(f'{what}: a step\'s loss differs by more than {CP_LOSS_REL} '
             f'of MaskedPLM\'s: {losses} vs {ref_losses}')
    return check


def check_cp_train(dev, phase5, profile_dir=None):
    """Phase 11, context-parallel training: a one-rank world (NCCL on the
    card) on 127.0.0.1 and its ``(data, fsdp, seq)`` mesh of (1, 1, 1);
    ESM2 at ``MODEL`` (bf16, seed-0 weights, as phase 4 builds it) with
    ``checkpointing=True`` on TRAIN_CELLS' ``ckpt@50k`` batch. The loss and
    every leaf's gradient of one step of ``ShardedMaskedPLM(seq_axis=
    'seq')`` against ``MaskedPLM``'s in the same call (the loss equal,
    each leaf under phase 5's gates; the largest difference and the count
    of bit-equal leaves logged); then ``train_cell`` with the sharded
    trainer: launches exact in one step (H9 twice and H10 once per layer,
    H3 three times, its inverse once; H1 and H2 never), the losses of
    ``CP_TRAIN_STEPS`` more steps finite and the last below the first, ms
    per step, real tokens/s, MFU and peak memory beside phase
    5's ``ckpt@50k`` cell (``phase5``); then :func:`check_cp_steps`. The
    process group is destroyed at the end."""
    import torch.distributed as dist
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM
    key, budget, ckpt, _, _ = TRAIN_CELLS[1]
    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0,
                           device=dev.type)
    try:
        mesh = make_mesh(1, 1, seq=1, device=dev.type)
        log(f'context-parallel training: {dist.get_backend()} world of '
            f'{dist.get_world_size()}, mesh {mesh}')
        model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev,
                     checkpointing=True)
        n_params = sum(p.numel() for p in _leaves(model.params))
        L = model.config.num_layers
        batch, _ = train_batch(budget, model)

        class sharded:
            """The sharded trainer on the mesh, stepped with the one data
            row's batch (R = 1), as ``train_cell`` steps a trainer."""

            def __init__(self, m, learning_rate):
                self.plm = ShardedMaskedPLM(m, mesh,
                                            learning_rate=learning_rate,
                                            seq_axis='seq')

            def training_step(self, batch):
                return self.plm.training_step([batch])
        loss_ref, grads_ref = MaskedPLM(model)._grad_step(batch)
        loss, grads = sharded(model, 1e-4).plm._grad_step([batch])
        what = (f'context-parallel training ({L} layers, '
                f'{int(batch.cu_lens[-1])} tokens): gradients, '
                'ShardedMaskedPLM vs MaskedPLM')
        check = compare_grads(grads, grads_ref, GRAD_MIN_COS, GRAD_MAX_REL,
                              what)
        check['max_abs'] = max((a.float() - b.float()).abs().max().item()
                               for _, a, b in _leaf_pairs(grads, grads_ref))
        check.update(loss=loss.item(), loss_masked_plm=loss_ref.item(),
                     loss_equal=bool(torch.equal(loss, loss_ref)))
        log(f'{what}: loss {loss.item():.6f} vs {loss_ref.item():.6f}, equal '
            f'{check["loss_equal"]}; max|g - g_MaskedPLM| over every leaf '
            f'{check["max_abs"]:.3e}; {check["bit_equal"]} of '
            f'{check["leaves"]} leaves bit-equal')
        if not check['loss_equal']:
            fail('a one-rank ShardedMaskedPLM step\'s loss is not '
                 'MaskedPLM\'s')
        del grads, grads_ref
        torch.cuda.empty_cache()
        cell = train_cell(
            model, sharded, f'cp_{key}', budget, ckpt, CP_TRAIN_STEPS, True,
            n_params, profile_dir, what='ShardedMaskedPLM(seq_axis=seq): ',
            expected=expected_launches(**{
                H9_NAME: 2 * L, H10_NAME: L, H3_NAME: 3 * L,
                'rope_inverse': L}))
        cell['vs_masked_plm'] = check
        cell['phase5_ms_per_step'] = phase5['ms_per_step']
        model.checkpointing = ckpt
        cell['steps_vs_masked_plm'] = check_cp_steps(model, mesh, batch,
                                                     1e-4, dev)
        log(f'context-parallel training: {cell["ms_per_step"]:.2f} ms per '
            f'step, {cell["real_tokens_per_s"]:.1f} real tokens/s, MFU '
            f'{cell["mfu"]:.4f}, peak memory {cell["peak_mem_gib"]:.2f} GiB; '
            f'MaskedPLM\'s ckpt@50k (phase 5) {phase5["ms_per_step"]:.2f} ms, '
            f'{phase5["real_tokens_per_s"]:.1f} real tokens/s, MFU '
            f'{phase5["mfu"]:.4f}, {phase5["peak_mem_gib"]:.2f} GiB '
            f'({cell["ms_per_step"] / phase5["ms_per_step"]:.4f} of its time)')
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return cell


def parse_args(argv):
    """``[--profile DIR] [--sizes NAME,...] [--ranks N]``: returns
    ``(profile_dir, runs, ranks)``, ``runs`` the entries of ``SIZE_RUNS``
    named (None without ``--sizes``: every phase), ``ranks`` the cards of
    phase 20 (None without ``--ranks``; N in ``RANK_CHOICES``)."""
    usage = ('usage: python3 chip_smoke.py [--profile DIR] '
             f'[--sizes NAME,...] (NAME in {[n for n, _ in SIZE_RUNS]}) | '
             f'[--profile DIR] [--ranks N] (N in {RANK_CHOICES}); got {argv}')
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or len(opts) != len(argv) // 2 \
            or set(opts) - {'--profile', '--sizes', '--ranks'} \
            or {'--sizes', '--ranks'} <= set(opts):
        fail(usage)
    runs = ranks = None
    if '--sizes' in opts:
        names = opts['--sizes'].split(',')
        runs = tuple(r for r in SIZE_RUNS if r[0] in names)
        if len(runs) != len(set(names)):
            fail(usage)
    if '--ranks' in opts:
        if opts['--ranks'] not in [str(n) for n in RANK_CHOICES]:
            fail(usage)
        ranks = int(opts['--ranks'])
    return opts.get('--profile'), runs, ranks


def main(argv):
    if not torch.cuda.is_available():
        fail('no CUDA device: this script runs the port on the card')
    profile_dir, size_runs, ranks = parse_args(argv)
    if ranks is not None and torch.cuda.device_count() < ranks:
        fail(f'--ranks {ranks} needs {ranks} cards; this machine has '
             f'{torch.cuda.device_count()}')
    try:
        from esme_tpu_torch import _build
        from esme_tpu_torch.ops import flash, headsplit
        from esme_tpu_torch.train import MaskedPLM
        from esme_tpu_torch.ops.rotary import rotary_cos_sin
    except ImportError as e:
        fail(f'the esme_tpu_torch package is not beside this script ({e})')
    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    phase_s, t_phase = {}, [t_start]

    def phase_done(n):
        now = time.perf_counter()
        phase_s[n] = now - t_phase[0]
        t_phase[0] = now
        log(f'phase {n}: {phase_s[n]:.1f} s')

    # 1. the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    cards = [line.strip() for line in smi.stdout.strip().splitlines()]
    card = cards[0]
    for line in cards:
        print(line, flush=True)
    if ranks is not None:          # how the cards are joined
        topo = subprocess.run(['nvidia-smi', 'topo', '-m'],
                              capture_output=True, text=True, timeout=60)
        log(f'nvidia-smi topo -m:\n{topo.stdout.strip()}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} '
        f'device(s), python {sys.version.split()[0]}')
    phase_done(1)

    # 2. build
    t0 = time.perf_counter()
    compiled = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    for name in _build.SIGNATURES:
        _build.library(name)
    log(f'build: {build_s:.1f} s wall, per source {compiled} '
        f'(empty: already built in {_build._build_dir()})')
    check_mode0_ptxas()
    sm90_usage = check_sm90_ptxas()
    h8_ptxas = check_probes_sm90_ptxas()
    rect_ptxas = check_rect_ptxas()
    rect_bwd_ptxas = check_rect_bwd_ptxas()
    phase_done(2)
    if ranks is not None:          # phase 20 alone, on `ranks` cards
        phase20_main(ranks, cards, profile_dir, phase_done, phase_s,
                     build_s, t_start)
        return
    if size_runs is not None:      # phase 12 alone, on the sizes named
        from esme_tpu_torch.models.config import ESM2_SIZES
        dims = {(c['embed_dim'] // c['attention_heads'],
                 c['attention_heads'])
                for c in (ESM2_SIZES[n] for n, _ in size_runs)}
        sizes, rows = check_sizes(
            dev, MaskedPLM, packed_batch(BUDGET, seed=0), size_runs,
            tuple(dh for dh in SIZE_HEAD_DIMS if dh in dims), profile_dir)
        print(json.dumps({'card': card, 'sizes': sizes,
                          'head_dims': rows,
                          'wall_s': time.perf_counter() - t_start}),
              flush=True)
        return

    # 3. kernels vs plain versions
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H
    _, cu8k, _ = packed_batch(CHECK_BUDGET, seed=1)
    h2_check_share = 0.0
    for d, h in ((16, 20), (24, 20), (32, 20), (64, 20), (128, 40)):
        check_flash(cu8k, CHECK_BUDGET, h, d, dev, seed=d)
        h2_check_share = max(h2_check_share, check_flash_bwd(
            cu8k, CHECK_BUDGET, h, d, dev, seed=d)[1])
        if d in PADDED_HEAD_DIMS:      # the other form of each, there too
            q, k, v, seg, _, spans = flash_inputs(cu8k, CHECK_BUDGET, h, d,
                                                  dev, d)
            for lib in flash.FWD_ROUTES:
                if lib != flash.fwd_route(d):
                    check_flash_args((q, k, v, seg, *spans[:2], h),
                                     library=lib)
            inputs = bwd_inputs(cu8k, CHECK_BUDGET, h, d, dev, d)
            for lib in flash.BWD_ROUTES:
                if lib != flash.bwd_route(d):
                    check_bwd_args(inputs, h, d, library=lib)
            del q, k, v, inputs
    for layout in BWD_LAYOUTS:        # masked and unmasked tiles
        seg = layout_seg(layout, CHECK_BUDGET, dev, seed=5)
        for d in flash.HEAD_DIMS:
            h2_check_share = max(h2_check_share, check_bwd_args(
                seg_bwd_inputs(seg, 4, d, dev, d), 4, d, f' {layout}')[1])
        # H1 there too, and at a ragged T (T % 64 != 0)
        for t in (CHECK_BUDGET, CHECK_BUDGET - 27):
            for d in flash.HEAD_DIMS:
                check_flash_args(seg_flash_args(seg[:t], 4, d, dev, d + t),
                                 f' {layout}')
    rect_err, rect_lse_err = check_rect(cu8k, dev)
    rect_bwd_err, rect_bwd_share = check_rect_bwd(cu8k, dev)
    for d in (16, 24, 32, 128):
        check_rope(CHECK_BUDGET, 20 if d < 128 else 40, d, dev, seed=d)
    rope_err = check_rope(BUDGET + (-BUDGET) % 256, H, D, dev)
    for d in (16, 24, 32, 64, 128):
        for t in (CHECK_BUDGET, CHECK_BUDGET - 1):    # T % 8 != 0 too
            check_relayout(t, 20 if d < 128 else 40, d, dev)
    phase_done(3)

    # 4. the inference path
    from esme_tpu_torch import ESM2
    t0 = time.perf_counter()
    model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(model.params))
    log(f'ESM2 {MODEL} init on the card: {time.perf_counter() - t0:.1f} s, '
        f'{n_params:,} params')
    tokens, cu, max_len = packed_batch(BUDGET, seed=0)
    real = int(cu[-1])
    log(f'main batch: {len(cu) - 1} sequences, {real} real tokens, '
        f'budget {BUDGET}, max_len {max_len}')
    L = model.config.num_layers
    launches = inference_run(model, (tokens, cu, max_len), 'inference path',
                             expected_launches(**{H1_NAME: L, H3_NAME: L}))
    model_checks = plain_checks(model, '')
    infer = inference_times(model, (tokens, cu, max_len), 'inference path')
    if profile_dir:
        _profile(lambda: model.predict_log_prob(tokens,
                                                pad_args=(cu, max_len)),
                 profile_dir, 'profile_main.txt', 'forward')
    phase_done(4)

    # 5. the training path
    cells = {}
    for key, budget, ckpt, reps, falls in TRAIN_CELLS:
        cells[key] = train_cell(model, MaskedPLM, key, budget, ckpt, reps,
                                falls, n_params, profile_dir)
    grad_checks = check_grads(model, MaskedPLM)
    fit_losses = check_fit(model, MaskedPLM)
    del model
    torch.cuda.empty_cache()
    phase_done(5)

    # 6. the attention op API
    ops = check_op_api(cu, dev)
    phase_done(6)

    # 7. times
    h1_err, h1_lse_err = check_flash(cu, BUDGET, H, D, dev, seed=7,
                                     what=' at the main shape')
    q, k, v, seg, pos, spans = flash_inputs(cu, BUDGET, H, D, dev, 7)
    ks, ke = spans[:2]
    h1_args = (q, k, v, seg, ks, ke, H)
    T = q.shape[0]
    o, _ = flash.segment_flash_fwd(*h1_args)
    h1_ms = cuda_ms(lambda: flash.segment_flash_fwd(*h1_args), reps=20,
                    warmup=2)
    # the mma.sync form (H6 `baseline`'s kernel) through its C entry
    h1_mma_sync_ms = cuda_ms(lambda: mma_sync_fwd(h1_args), reps=20,
                             warmup=2)
    h1_plain_ms = cuda_ms(lambda: flash.segment_flash_fwd_plain(*h1_args),
                          reps=2)
    h1_bytes, h1_flops = flash_work(q, seg, ks, H, D)
    h1_bound, h1_by = bound(h1_bytes, h1_flops, BF16_FLOP_PER_S)
    h1_lib_ms = yardstick(
        'SDPA (dense block-diagonal mask)',
        lambda: sdpa_ms(q, k, v, seg, H, D, reps=3), o)
    h1_varlen_ms = yardstick(
        'varlen flash-attention forward (aten)',
        lambda: varlen_flash_ms(q, k, v, seg, H, D, reps=20), o)
    u, n = mask_units(seg, spans)['dq']
    h1_units = {'unmasked': u, 'total': n, 'share': u / n}
    log(f'H1 at the main shape: {h1_ms:.4f} ms ({flash.fwd_route(D)}), the '
        f'mma.sync form {h1_mma_sync_ms:.4f} ms '
        f'({h1_ms / h1_mma_sync_ms:.4f}), '
        + (f'{h1_ms / h1_varlen_ms:.4f} of the varlen library '
           f'({h1_varlen_ms:.4f} ms; logged, not a gate)' if h1_varlen_ms
           else 'no varlen library time')
        + f'; the batch\'s unmasked (16-row, 64-key) units per head '
        f'{h1_units}')
    if not h1_ms < h1_mma_sync_ms:
        fail(f'H1 ({h1_ms:.4f} ms) is not faster than its mma.sync form '
             f'({h1_mma_sync_ms:.4f} ms) at the main shape')

    cos, sin = rotary_cos_sin(pos, D)
    h3_ms = cuda_ms(lambda: headsplit.rotary_qk(q, k, cos, sin, H),
                    reps=20, warmup=2)
    h3_plain_ms = cuda_ms(lambda: headsplit.rotary_qk_plain(
        q, k, cos, sin, H), reps=5)
    # q and k read and written once; of the tables, the halves
    # [:, :D/2] that H3 reads (csrc/rope.cu)
    h3_bytes = 4 * q.numel() * 2 + cos.numel() * 2
    h3_bound, h3_by = bound(h3_bytes, 6.0 * q.numel(), FP32_FLOP_PER_S)
    del q, k, v, o, cos, sin, h1_args
    torch.cuda.empty_cache()
    h1_mask_skip = time_fwd_mask_skip(T, H, D, dev)

    # H2 at the 50k train cell's shape (bench.py's train batch, seed 2)
    _, tcu, _ = packed_batch(BUDGET, seed=2)
    h2_err, h2_share = check_flash_bwd(tcu, BUDGET, H, D, dev, seed=9,
                                       what=' at the train shape')
    q, k, v, do, lse, delta, tseg, tspans = bwd_inputs(tcu, BUDGET, H, D,
                                                       dev, 9)
    TT = q.shape[0]
    h2_args = (q, k, v, do, lse, delta, tseg, *tspans, H)
    dq = flash.segment_flash_bwd(*h2_args)[0]
    h2_ms = cuda_ms(lambda: flash.segment_flash_bwd(*h2_args), reps=20,
                    warmup=2)
    # each pass of the Hopper form alone; the mma.sync form (H7 `real`'s
    # pair); the batch's unmasked tiles by the kernel's rule
    h2_passes = {name: cuda_ms(lambda: sm90_pass(which, h2_args), reps=20,
                               warmup=2)
                 for which, name in ((0, 'dkv'), (1, 'dq'))}
    mma_sync_ms = cuda_ms(lambda: mma_sync_bwd(h2_args), reps=20, warmup=2)
    units = {name: {'unmasked': a, 'total': b, 'share': a / b}
             for name, (a, b) in mask_units(tseg, tspans).items()}
    log(f'H2 at the train shape: {h2_ms:.4f} ms (dk/dv, then dq); passes '
        f'alone {h2_passes}; the mma.sync form {mma_sync_ms:.4f} ms; the '
        f'batch\'s unmasked (16-row, 64-row tile) units per head {units}')
    h2_plain_ms = cuda_ms(lambda: flash.segment_flash_bwd_plain(*h2_args),
                          reps=2)
    h2_bytes, h2_flops = flash_bwd_work(q, tseg, tspans, H, D)
    h2_bound, h2_by = bound(h2_bytes, h2_flops, BF16_FLOP_PER_S)
    h2_lib_ms = yardstick(
        'varlen flash-attention backward (aten)',
        lambda: varlen_flash_bwd_ms(q, k, v, do, tseg, H, D, reps=20), dq,
        'H2 dq')
    del q, k, v, do, dq, h2_args
    torch.cuda.empty_cache()
    mask_skip = time_mask_skip(TT, H, D, dev)

    h4_modes = time_relayouts(T, H, D, dev, card)
    h4 = h4_modes[next(iter(RELAYOUTS))]
    phase_done(7)

    # 8. the probe tools' kernels
    probe_kernels = check_probes(
        dev, {'ms': h1_ms, 'mma_sync_ms': h1_mma_sync_ms},
        {'ms': h2_ms, 'mma_sync_ms': mma_sync_ms, 'library_ms': h2_lib_ms},
        card, h8_ptxas)
    phase_done(8)

    # 9. the other families
    family_kernels, families = check_families(
        dev, MaskedPLM, (tokens, cu, max_len), profile_dir)
    phase_done(9)

    # 10. context parallelism: the path, then H9's times
    cp = check_cp(dev, (tokens, cu, max_len), infer['ms_per_batch'])
    h9 = time_rect(cu, dev)
    h9.update(launches=cp['launches'][H9_NAME],
              check_batch_max_abs_err=rect_err,
              check_batch_lse_max_abs_err=rect_lse_err, ptxas=rect_ptxas)
    phase_done(10)

    # 11. context-parallel training: the path, then H10's times
    cp_train = check_cp_train(dev, cells['ckpt'], profile_dir)
    h10 = time_rect_bwd(dev)
    h10.update(launches=cp_train['launches'][H10_NAME],
               check_batch_max_abs_err=rect_bwd_err,
               check_batch_gate_share=rect_bwd_share, ptxas=rect_bwd_ptxas)
    phase_done(11)

    # 12. every ESM2 size, then H1's and H2's times at their head dims
    sizes, head_dim_rows = check_sizes(dev, MaskedPLM, (tokens, cu, max_len),
                                       profile_dir=profile_dir)
    for kernel, row in head_dim_rows.items():
        for d, r in row.items():
            size = next(n for n, s in sizes.items()
                        if str(s['head_dim']) == d)
            r['size'] = size
            r['launches'] = sizes[size]['launches'][kernel] \
                if kernel == H1_NAME else {
                    key: c['launches'][kernel]
                    for key, c in sizes[size]['train'].items()}
    phase_done(12)

    # 13. the memory slice
    memory = check_memory(dev, card, cp_train, sizes)
    phase_done(13)

    # 14. the fine-tune slice
    finetune = check_finetune(dev, card, cells['nockpt'], profile_dir)
    phase_done(14)

    # 15. variant scoring, the data plane, position extension, the CLI
    phase15 = check_phase15(dev, card)
    phase_done(15)

    # 16. weight quantization
    quant = check_quant(dev, card, cells['nockpt'], finetune,
                        phase15['a_b_scoring'], profile_dir)
    phase_done(16)

    # 17. LoRA and QLoRA over the mesh; checkpoint and resume
    phase17 = check_phase17(dev, card)
    phase_done(17)
    lora_launches = {f'{trainer} {trunk}': phase17[cell][trainer]['launches']
                     for cell, trunk in (('a_lora', 'dense'),
                                         ('b_qlora', 'nf4'))
                     for trainer in ('sharded', 'masked_plm')}

    # 18. a sharded state restored on a mesh of another shape
    phase18 = check_phase18(dev, card)
    phase_done(18)
    reshard_launches = {kind: phase18[kind]['launches']
                        for kind, _ in RESHARD_CELLS}

    # 19. trainer states restored by leaf path
    phase19 = check_phase19(dev, card)
    phase_done(19)
    state_launches = {key: c['launches'] for key, c in phase19.items()
                      if key != 'seconds'}
    big_qlora = next((n for n in SIZE_QLORA if 'qlora' in sizes.get(n, {})),
                     None)
    if big_qlora:
        lora_launches[f'{big_qlora} qlora'] = sizes[big_qlora]['qlora'][
            'launches']
    quant_fwd = {mode: quant['c_times']['launches'][mode]
                 for mode in QUANT_MODES}
    qlora_step = quant['d_qlora']['times']['launches']
    big = next((n for n in SIZE_QUANTIZE if n in sizes), None)
    if big:
        quant_fwd[f'{big} {SIZE_QUANTIZE[big]}'] = sizes[big]['quantized'][
            'launches']
    scoring = phase15['a_b_scoring']
    fwd_launches = {key: {k: v // scoring[key]['forwards']
                          for k, v in scoring[key]['launches'].items()}
                    for key in ('mask_margin', 'long')}
    data_fed = {name: {k: v // DATA_STEPS for k, v in c['launches'].items()}
                for name, c in phase15['c_data_plane']['steps'].items()}
    ft_step = finetune['d_times']['gb1_265']['launches']
    ft_predict = finetune['d_times']['gb1_265']['predict_launches']
    attn_cells = {'esm2_650m': memory['a_esm2_650m'],
                  **{name: memory[f'b_{name}'] for name in MEMORY_FAMILIES}}

    train_launches = {key: c['launches'] for key, c in cells.items()}
    kernels = [
        {'name': H1_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
         'routes': {str(d): f'esme_tpu_torch/csrc/{flash.fwd_route(d)}.cu'
                    for d in flash.HEAD_DIMS},
         'replaces': 'esme_tpu/ops/flash.py:370',
         'also_replaces': ['esme_tpu/ops/flash.py:257',
                           'esme_tpu/ops/flash_v2.py:45',
                           'esme_tpu/ops/headsplit.py:114',
                           'esme_tpu/ops/headsplit.py:235'],
         'launches': launches[H1_NAME],
         'train_launches': {key: c[H1_NAME]
                            for key, c in train_launches.items()},
         'remat_launches': {f'{name} ckpt {remat}': cell[remat]['launches'][
             H1_NAME] for name, cell in attn_cells.items()
             for remat in ('full', 'attn')},
         'finetune_launches': {'step': ft_step[H1_NAME],
                               'predict': ft_predict[H1_NAME]},
         'scoring_launches_per_forward': {
             key: c[H1_NAME] for key, c in fwd_launches.items()},
         'data_fed_launches_per_step': {
             key: c[H1_NAME] for key, c in data_fed.items()},
         'esm1b_extended_launches': phase15['e_extension'][
             'long_launches'][H1_NAME],
         'quant_launches': {**{key: c[H1_NAME]
                               for key, c in quant_fwd.items()},
                            'qlora_step': qlora_step[H1_NAME]},
         'lora_step_launches': {key: c[H1_NAME]
                                for key, c in lora_launches.items()},
         'reshard_step_launches': {key: c[H1_NAME]
                                   for key, c in reshard_launches.items()},
         'state_resume_launches': {key: c[H1_NAME]
                                   for key, c in state_launches.items()},
         'max_abs_err': h1_err,
         'lse_max_abs_err': h1_lse_err, 'ms': h1_ms,
         'plain_ms': h1_plain_ms, 'bound_ms': h1_bound, 'bound_by': h1_by,
         'library_ms': h1_lib_ms, 'library_varlen_ms': h1_varlen_ms,
         'mma_sync_form_ms': h1_mma_sync_ms, 'mask_skip_ms': h1_mask_skip,
         'head_dims': head_dim_rows[H1_NAME],
         'ptxas': sm90_usage['flash_fwd_sm90'],
         'shape': f'T={T} H={H} D={D} bf16',
         'bytes': h1_bytes, 'flops': h1_flops},
        {'name': H2_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/flash_bwd_sm90.cu',
         'routes': {str(d): f'esme_tpu_torch/csrc/{flash.bwd_route(d)}.cu'
                    for d in flash.HEAD_DIMS},
         'replaces': 'esme_tpu/ops/flash.py:475',
         'also_replaces': ['esme_tpu/ops/flash.py:511',
                           'esme_tpu/ops/flash.py:552',
                           'esme_tpu/ops/flash.py:581',
                           'esme_tpu/ops/flash.py:628',
                           'esme_tpu/ops/headsplit.py:114',
                           'esme_tpu/ops/headsplit.py:235'],
         'launches': train_launches['nockpt'][H2_NAME],
         'train_launches': {key: c[H2_NAME]
                            for key, c in train_launches.items()},
         'finetune_launches': {'step': ft_step[H2_NAME],
                               'predict': ft_predict[H2_NAME]},
         'data_fed_launches_per_step': {
             key: c[H2_NAME] for key, c in data_fed.items()},
         'quant_launches': {**{key: c[H2_NAME]
                               for key, c in quant_fwd.items()},
                            'qlora_step': qlora_step[H2_NAME]},
         'lora_step_launches': {key: c[H2_NAME]
                                for key, c in lora_launches.items()},
         'reshard_step_launches': {key: c[H2_NAME]
                                   for key, c in reshard_launches.items()},
         'state_resume_launches': {key: c[H2_NAME]
                                   for key, c in state_launches.items()},
         'max_abs_err': h2_err, 'gate_share': max(h2_share, h2_check_share),
         'ms': h2_ms, 'plain_ms': h2_plain_ms, 'bound_ms': h2_bound,
         'bound_by': h2_by, 'library_ms': h2_lib_ms,
         'passes_ms': h2_passes, 'mma_sync_form_ms': mma_sync_ms,
         'mask_skip_ms': mask_skip, 'head_dims': head_dim_rows[H2_NAME],
         'ptxas': sm90_usage['flash_bwd_sm90'],
         'shape': f'T={TT} H={H} D={D} bf16 (train batch)',
         'bytes': h2_bytes, 'flops': h2_flops},
        {'name': H3_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/rope.cu',
         'replaces': 'esme_tpu/ops/headsplit.py:119',
         'also_replaces': ['esme_tpu/ops/headsplit.py:235 (rotating, '
                           'inverse=True)'],
         'launches': launches[H3_NAME],
         'train_launches': {key: c[H3_NAME]
                            for key, c in train_launches.items()},
         'inverse_launches': {key: c['rope_inverse']
                              for key, c in train_launches.items()},
         'finetune_launches': {'step': ft_step[H3_NAME],
                               'predict': ft_predict[H3_NAME]},
         'finetune_inverse_launches': ft_step['rope_inverse'],
         'scoring_launches_per_forward': {
             key: c[H3_NAME] for key, c in fwd_launches.items()},
         'data_fed_launches_per_step': {
             key: c[H3_NAME] for key, c in data_fed.items()},
         'quant_launches': {**{key: c[H3_NAME]
                               for key, c in quant_fwd.items()},
                            'qlora_step': qlora_step[H3_NAME],
                            'qlora_step_inverse': qlora_step['rope_inverse']},
         'lora_step_launches': {key: c[H3_NAME]
                                for key, c in lora_launches.items()},
         'lora_step_inverse_launches': {key: c['rope_inverse'] for key, c
                                        in lora_launches.items()},
         'reshard_step_launches': {key: c[H3_NAME]
                                   for key, c in reshard_launches.items()},
         'reshard_step_inverse_launches': {
             key: c['rope_inverse'] for key, c in reshard_launches.items()},
         'state_resume_launches': {key: c[H3_NAME]
                                   for key, c in state_launches.items()},
         'state_resume_inverse_launches': {
             key: c['rope_inverse'] for key, c in state_launches.items()},
         'max_abs_err': rope_err,
         'ms': h3_ms, 'plain_ms': h3_plain_ms, 'bound_ms': h3_bound,
         'bound_by': h3_by, 'library_ms': None,
         'shape': f'T={T} H={H} D={D} bf16', 'bytes': h3_bytes},
        {'name': H4_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/headsplit.cu',
         'routes': {'no hdt side': 'relayout_rows_kernel',
                    'an hdt side, T % 8 == 0': 'relayout_vec_kernel',
                    'an hdt side, T % 8 != 0': 'relayout_tile_kernel'},
         'replaces': 'esme_tpu/ops/headsplit.py:52',
         'also_replaces': ['esme_tpu/ops/headsplit.py:70',
                           'esme_tpu/ops/headsplit.py:75',
                           'esme_tpu/ops/headsplit.py:216'],
         'launches': sum(r['launches'][H4_NAME] for r in ops.values()),
         'inference_launches': launches[H4_NAME],
         'train_launches': {key: c[H4_NAME]
                            for key, c in train_launches.items()},
         'op_launches': {op: r['launches'][H4_NAME]
                         for op, r in ops.items()},
         'max_abs_err': max(m['max_abs_err'] for m in h4_modes.values()),
         'ms': h4['ms'], 'plain_ms': h4['plain_ms'],
         'bound_ms': h4['bound_ms'], 'bound_by': h4['bound_by'],
         'library_ms': h4['library_ms'], 'mode': next(iter(RELAYOUTS)),
         'modes': h4_modes, 'shape': f'T={T} H={H} D={D} bf16',
         'bytes': h4['bytes']},
        {**h9, 'attn_train_launches': memory['c_context_parallel']['attn'][
            'launches'][H9_NAME],
         'lora_step_launches': {key: c[H9_NAME]
                                for key, c in lora_launches.items()},
         'reshard_step_launches': {key: c[H9_NAME]
                                   for key, c in reshard_launches.items()}},
        {**h10, 'lora_step_launches': {key: c[H10_NAME]
                                       for key, c in lora_launches.items()},
         'reshard_step_launches': {key: c[H10_NAME]
                                   for key, c in reshard_launches.items()}},
        *probe_kernels,
        *family_kernels,
    ]
    for kd in kernels:
        log(f"{kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f} "
            f"ms by {kd['bound_by']}), plain {kd['plain_ms']:.3f} ms, "
            f"library {kd['library_ms']}, varlen library "
            f"{kd.get('library_varlen_ms')}")
    measured = {
        'card': card, 'model': f'ESM2 {MODEL} bf16, seed-0 random weights',
        'batch': f'bench.py seed 0: {len(cu) - 1} seqs, {real} real tokens, '
        f'budget {BUDGET}',
        **infer,
        'train': cells, 'grad_checks': grad_checks, 'op_api': ops,
        'inference_batch_unmasked_units': h1_units,
        'train_batch_unmasked_units': units,
        'fit_losses': fit_losses, 'families': families,
        'context_parallel': cp,
        'context_parallel_training': cp_train,
        'sizes': sizes,
        'memory': memory,
        'finetune': finetune,
        'phase15': phase15,
        'quant': quant,
        'phase17': phase17,
        'phase18': phase18,
        'phase19': phase19,
        'phase_s': phase_s,
        'build_s': build_s,
        'model_checks': model_checks, 'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'wall_s': time.perf_counter() - t_start,
    }
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps(measured), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def family_model(name, cls_name, kwargs, seed, dev, tmp, keep=False):
    """``cls_name(**kwargs)`` with weights from ``seed`` on the card,
    written through the safetensors schema as ``name`` and loaded back
    with ``ESM.from_pretrained``: the loaded model must be of the same
    class and config, every leaf bit-equal. The file is removed unless
    ``keep``."""
    import esme_tpu_torch
    t0 = time.perf_counter()
    src = getattr(esme_tpu_torch, cls_name)(**kwargs, rng=seed, device=dev)
    path = os.path.join(tmp, f'{name}.safetensors')
    src.save_pretrained(path, name=name)
    t1 = time.perf_counter()
    model = esme_tpu_torch.ESM.from_pretrained(path, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    size = os.path.getsize(path)
    if not keep:
        os.remove(path)
    if type(model) is not type(src) or model.config != src.config \
            or model.name != name:
        fail(f'{name}: from_pretrained gave {type(model).__name__} '
             f'{model.config} named {model.name}')
    for leaf, a, b in _leaf_pairs(model.params, src.params):
        if not torch.equal(a, b):
            fail(f'{name}: {leaf} changed through the safetensors file')
    n_params = sum(p.numel() for p in _leaves(model.params))
    del src
    torch.cuda.empty_cache()
    cfg = model.config
    log(f'{name}: {type(model).__name__} {cfg.num_layers} layers, width '
        f'{cfg.embed_dim}, {cfg.attention_heads} heads, vocab '
        f'{cfg.vocab_size}, {n_params:,} params; init and write '
        f'{t1 - t0:.1f} s, load {t2 - t1:.1f} s ({size / 2**30:.2f} GiB), '
        'every leaf bit-equal')
    return model, n_params


def check_overflow(model, what):
    """A sequence wider than the learned position table raises
    ``ValueError`` before any launch, on the ``pad_args`` route and the
    padded route; one at the table's width runs."""
    from esme_tpu_torch import Alphabet
    n = model.config.learned_positions
    rng = np.random.default_rng(3)

    def seq(residues):
        return np.concatenate([[Alphabet.cls_idx],
                               rng.integers(4, 24, residues),
                               [Alphabet.eos_idx]]).astype(np.int32)
    over = seq(n - 1)
    calls = {'pad_args': lambda: model.predict_log_prob(
        over, pad_args=(np.array([0, n + 1], np.int32), n + 1)),
        'padded': lambda: model.predict_log_prob(over[None])}
    torch.cuda.synchronize()
    reset_counters()
    for route, call in calls.items():
        try:
            call()
        except ValueError as e:
            log(f'{what}: {n - 1} residues on the {route} route: '
                f'ValueError({e})')
        else:
            fail(f'{what}: {n - 1} residues ran on the {route} route')
    torch.cuda.synchronize()
    expect_launches(f'{what}: the overflowing calls', read_counters())
    lp = model.predict_log_prob(seq(n - 2)[None])
    if not bool(torch.isfinite(lp).all()):
        fail(f'{what}: {n - 2} residues gave log-probs that are not finite')
    log(f'{what}: {n - 2} residues ({n} tokens) run, finite')
    return {'residues_refused': n - 1, 'residues_run': n - 2}


def family_kernel_rows(dev, H):
    """H1, H2 and H3 at head count ``H`` (D = 64) on the main shapes:
    each against its plain version under phase 3's gates, timed beside its
    bound, its plain version and the varlen library call (H1 on the
    inference batch, H2 on the 50k train batch, H3 on the inference
    batch's positions). Returns the kernels line's rows without launches
    (the model runs give those)."""
    from esme_tpu_torch.ops import flash, headsplit
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    D = 64
    _, cu, _ = packed_batch(BUDGET, seed=0)
    e_o, e_l = check_flash(cu, BUDGET, H, D, dev, seed=7,
                           what=f' (H={H}) at the main shape')
    q, k, v, seg, pos, spans = flash_inputs(cu, BUDGET, H, D, dev, 7)
    T = q.shape[0]
    args = (q, k, v, seg, *spans[:2], H)
    o, _ = flash.segment_flash_fwd(*args)
    ms = cuda_ms(lambda: flash.segment_flash_fwd(*args), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: flash.segment_flash_fwd_plain(*args), reps=2)
    nbytes, flops = flash_work(q, seg, spans[0], H, D)
    b, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    lib = yardstick(f'varlen flash-attention forward (aten), H={H}',
                    lambda: varlen_flash_ms(q, k, v, seg, H, D, reps=20), o)
    rows = {H1_NAME: {'max_abs_err': e_o, 'lse_max_abs_err': e_l, 'ms': ms,
                      'plain_ms': plain_ms, 'bound_ms': b, 'bound_by': by,
                      'library_ms': lib, 'shape': f'T={T} H={H} D={D} bf16',
                      'bytes': nbytes, 'flops': flops}}
    rope_err = check_rope(T, H, D, dev, seed=H)
    cos, sin = rotary_cos_sin(pos, D)
    ms = cuda_ms(lambda: headsplit.rotary_qk(q, k, cos, sin, H), reps=20,
                 warmup=2)
    plain_ms = cuda_ms(lambda: headsplit.rotary_qk_plain(q, k, cos, sin, H),
                       reps=5)
    nbytes = 4 * q.numel() * 2 + cos.numel() * 2
    b, by = bound(nbytes, 6.0 * q.numel(), FP32_FLOP_PER_S)
    rows[H3_NAME] = {'max_abs_err': rope_err, 'ms': ms, 'plain_ms': plain_ms,
                     'bound_ms': b, 'bound_by': by, 'library_ms': None,
                     'shape': f'T={T} H={H} D={D} bf16', 'bytes': nbytes}
    del q, k, v, o, cos, sin, args
    torch.cuda.empty_cache()

    _, tcu, _ = packed_batch(BUDGET, seed=2)
    err, share = check_flash_bwd(tcu, BUDGET, H, D, dev, seed=9,
                                 what=f' (H={H}) at the train shape')
    q, k, v, do, lse, delta, tseg, tspans = bwd_inputs(tcu, BUDGET, H, D,
                                                       dev, 9)
    args = (q, k, v, do, lse, delta, tseg, *tspans, H)
    dq = flash.segment_flash_bwd(*args)[0]
    ms = cuda_ms(lambda: flash.segment_flash_bwd(*args), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: flash.segment_flash_bwd_plain(*args), reps=2)
    nbytes, flops = flash_bwd_work(q, tseg, tspans, H, D)
    b, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    lib = yardstick(f'varlen flash-attention backward (aten), H={H}',
                    lambda: varlen_flash_bwd_ms(q, k, v, do, tseg, H, D,
                                                reps=20), dq, 'H2 dq')
    rows[H2_NAME] = {'max_abs_err': err, 'gate_share': share, 'ms': ms,
                     'plain_ms': plain_ms, 'bound_ms': b, 'bound_by': by,
                     'library_ms': lib,
                     'shape': f'T={q.shape[0]} H={H} D={D} bf16 (train '
                     'batch)', 'bytes': nbytes, 'flops': flops}
    del q, k, v, do, dq, args
    torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f'{name} at H={H}: {r["ms"]:.4f} ms (bound {r["bound_ms"]:.4f} '
            f'ms by {r["bound_by"]}, {r["ms"] / r["bound_ms"]:.2f}x), plain '
            f'{r["plain_ms"]:.3f} ms, library {r["library_ms"]}')
    return rows


def check_families(dev, plm_cls, main_batch, profile_dir=None):
    """Phase 9: ESMC, ESM1b and ESM1v. H1, H2 and H3 at ESMC's head
    counts against their plain versions on the 8k check batch, and at
    the main shapes with ESMC-300M's (timed); then each of
    ``FAMILY_RUNS`` at full width and depth from seeded random weights
    through the safetensors schema and ``ESM.from_pretrained``, its
    inference cell (launches exact: H1 and, with RoPE, H3 once per layer),
    its kernels against plain versions, its train cell and gradients, the
    position table's guard. Returns the kernels line's rows (named with
    their head count; ``launches`` from ESMC-300M's main paths) and the
    measurements. With ``profile_dir``, each model's inference and train
    cells are profiled into ``profile_dir/<name>/``."""
    D = 64
    _, cu8k, _ = packed_batch(CHECK_BUDGET, seed=1)
    for h in FAMILY_HEADS:
        check_flash(cu8k, CHECK_BUDGET, h, D, dev, seed=h, what=f' (H={h})')
        check_flash_bwd(cu8k, CHECK_BUDGET, h, D, dev, seed=h,
                        what=f' (H={h})')
        check_rope(CHECK_BUDGET, h, D, dev, seed=h)
    rows = family_kernel_rows(dev, FAMILY_HEADS[0])
    # the other head counts' forward kernels at the main inference shape,
    # which ESMC-600M's inference cell launches them at
    _, cu, _ = packed_batch(BUDGET, seed=0)
    T = flat_meta(cu, BUDGET, dev)[0].shape[0]
    for h in FAMILY_HEADS[1:]:
        check_flash(cu, BUDGET, h, D, dev, seed=h,
                    what=f' (H={h}) at the main shape')
        check_rope(T, h, D, dev, seed=h)
    torch.cuda.empty_cache()

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed, (name, cls_name, kwargs, runs) in enumerate(FAMILY_RUNS):
            model, n_params = family_model(name, cls_name, kwargs, seed, dev,
                                           tmp)
            cfg = model.config
            L, rot = cfg.num_layers, int(cfg.rotary)
            res = {'class': cls_name, 'layers': L, 'width': cfg.embed_dim,
                   'heads': cfg.attention_heads, 'params': n_params}
            prof = os.path.join(profile_dir, name) if profile_dir else None
            if 'infer' in runs:
                res['launches'] = inference_run(
                    model, main_batch, f'{name} inference',
                    expected_launches(**{H1_NAME: L, H3_NAME: rot * L}))
            if 'plain' in runs:
                res['model_checks'] = plain_checks(model, f'{name}: ')
            if 'infer' in runs:
                res['inference'] = inference_times(model, main_batch,
                                                   f'{name} inference')
                if prof:
                    tokens, cu, max_len = main_batch
                    _profile(lambda: model.predict_log_prob(
                        tokens, pad_args=(cu, max_len)), prof,
                        'profile_main.txt', f'{name} forward')
            if 'train' in runs:
                key, budget, ckpt, reps, falls = TRAIN_CELLS[0]
                res['train'] = {key: train_cell(
                    model, plm_cls, key, budget, ckpt, reps, falls, n_params,
                    prof, what=f'{name}: ')}
                res['grad_checks'] = check_grads(model, plm_cls,
                                                 what=f'{name}: ')
            if 'overflow' in runs:
                res['overflow'] = check_overflow(model, name)
            results[name] = res
            del model
            torch.cuda.empty_cache()

    first = results[FAMILY_RUNS[0][0]]
    kernels = []
    for kname, launches in (
            (H1_NAME, first['launches'][H1_NAME]),
            (H2_NAME, first['train']['nockpt']['launches'][H2_NAME]),
            (H3_NAME, first['launches'][H3_NAME])):
        by_model = {n: {'inference': r['launches'][kname]} if 'launches' in r
                    else {} for n, r in results.items()}
        for n, r in results.items():
            if 'train' in r:
                by_model[n]['train_nockpt'] = r['train']['nockpt'][
                    'launches'][kname]
        kernels.append({
            'name': f'{kname} (H={FAMILY_HEADS[0]})', 'route': 'cuda',
            'source': {H1_NAME: 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
                       H2_NAME: 'esme_tpu_torch/csrc/flash_bwd_sm90.cu',
                       H3_NAME: 'esme_tpu_torch/csrc/rope.cu'}[kname],
            'replaces': {H1_NAME: 'esme_tpu/ops/flash.py:370',
                         H2_NAME: 'esme_tpu/ops/flash.py:475',
                         H3_NAME: 'esme_tpu/ops/headsplit.py:119'}[kname],
            'launches': launches, 'launches_by_model': by_model,
            **rows[kname]})
    return kernels, results


def _counters():
    from esme_tpu_torch.ops import flash, headsplit
    from esme_tpu_torch.tools import (decompose_bwd, flash_variants,
                                      fwd_T_experiment, profile_attn)
    return {H1_NAME: flash.segment_flash_fwd,
            H2_NAME: flash.segment_flash_bwd, H3_NAME: headsplit.rotary_qk,
            H4_NAME: headsplit.relayout_heads,
            H5_NAME: fwd_T_experiment.fwd_T,
            H6_NAME: flash_variants.variant_fwd,
            H7_NAME: decompose_bwd.bwd_variant,
            **{name: getattr(profile_attn, name[len('probe_'):])
               for name in H8_NAMES}}


def reset_counters():
    for f in _counters().values():
        f.launches = 0
    _counters()[H1_NAME].rect_launches = 0
    _counters()[H2_NAME].rect_launches = 0
    _counters()[H3_NAME].inverse_launches = 0
    for name in (H4_NAME, H5_NAME):
        # (a plain version standing in for H4 counts no routes)
        routes = getattr(_counters()[name], 'routes', {})
        routes.update(dict.fromkeys(routes, 0))


def read_counters():
    return _launch_totals(_counters())


def train_batch(budget: int, model, seeds=(2, 1)):
    """``bench.py``'s masked-LM batch (``bench.py:50-85``): sequences and
    residues from seed 2, 80/10/10 masking from seed 1 in the model's
    alphabet (or ``seeds``), no loss on the padding tail. Returns the
    batch and the attention flops of one forward of ``model`` (4·Σn²·C·L,
    bench.py's ``attn_flops``)."""
    from esme_tpu_torch.alphabet import mask_tokens
    tokens, cu, max_len = packed_batch(budget, seed=seeds[0])
    masked, mask = mask_tokens(tokens[None], alphabet=model.alphabet,
                               rng=np.random.default_rng(seeds[1]))
    masked, mask = masked[0], mask[0]
    mask[cu[-1]:] = False
    lens = np.diff(cu).astype(np.float64)
    attn = 4 * float((lens ** 2).sum()) * model.config.embed_dim \
        * model.config.num_layers
    return SimpleNamespace(tokens=tokens, masked_tokens=masked, mask=mask,
                           cu_lens=cu, max_len=max_len), attn


def train_cell(model, plm_cls, key, budget, ckpt, reps, falls, n_params,
               profile_dir, what='', expected=None, after=None):
    """One train cell: a warm-up step with the launch counters set to 0
    just before it and read just after (``expected``, or MaskedPLM's
    launches: H1 once per layer, twice with checkpointing, H2 once; H3 only
    in a model with RoPE), then ``reps`` timed steps on the same batch. MFU
    as bench.py computes it: (6·N·tokens + 3.5·attention forward flops) /
    time / 989 TFLOP/s. ``after(plm)``, when given, checks the trainer
    after its steps; its dict joins the cell's."""
    L = model.config.num_layers
    rot = int(model.config.rotary)
    model.checkpointing = ckpt
    batch, attn_flops = train_batch(budget, model)
    real = int(batch.cu_lens[-1])
    plm = plm_cls(model, learning_rate=1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses = [plm.training_step(batch)]
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    if expected is None:
        expected = expected_launches(**{
            H1_NAME: 2 * L if ckpt else L, H2_NAME: L,
            H3_NAME: rot * (3 if ckpt else 2) * L, 'rope_inverse': rot * L})
    log(f'{what}train {key}@{budget}: launches in one step {launches} '
        f'(expected {expected})')
    if launches != expected:
        fail(f'{what}train {key}: a kernel of the training path launched '
             f'{launches}, not {expected}')
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(plm.training_step(batch))       # float(): a sync
        samples.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(samples))
    flops = 6 * n_params * real + 3.5 * attn_flops
    cell = {'budget': budget, 'checkpointing': ckpt, 'real_tokens': real,
            'sequences': len(batch.cu_lens) - 1, 'launches': launches,
            'losses': losses, 'first_step_ms': first_ms,
            'ms_per_step': ms, 'ms_per_step_samples': samples,
            'real_tokens_per_s': real / ms * 1e3,
            'mfu': flops / (ms * 1e-3) / MFU_PEAK,
            'peak_mem_gib': peak / 2**30}
    log(f'{what}train {key}@{budget}: losses {[round(x, 4) for x in losses]}, '
        f'median {ms:.2f} ms per step of {reps} (samples '
        f'{[round(x, 2) for x in samples]}), {cell["real_tokens_per_s"]:.1f} '
        f'real tokens/s, MFU {cell["mfu"]:.4f}, peak memory '
        f'{cell["peak_mem_gib"]:.2f} GiB')
    if not all(np.isfinite(losses)):
        fail(f'{what}train {key}: losses not finite: {losses}')
    if falls and not losses[-1] < losses[0]:
        fail(f'{what}train {key}: the last loss is not below the first: '
             f'{losses}')
    if after is not None:
        cell.update(after(plm))
    if profile_dir:
        _profile(lambda: plm.training_step(batch), profile_dir,
                 f'profile_train_{key}.txt',
                 f'{what}train step {key}@{budget}')
    model.checkpointing = False
    del plm
    torch.cuda.empty_cache()
    return cell


def compare_grads(got, ref, min_cos, max_rel, what, zero=None):
    """Per-leaf cosine and largest difference relative to the leaf's
    largest value; fails outside the gates. ``zero`` maps a leaf whose
    gradient is 0 in exact arithmetic to the leaf whose largest gradient
    scales its noise (``ZERO_GRAD_REL``)."""
    worst_cos, worst_rel, equal, n = 1.0, 0.0, 0, 0
    zero = zero or {}
    scales = {name: b.float().abs().max().item()
              for name, _, b in _leaf_pairs(got, ref) if name in
              zero.values()}
    noise = {}
    for name, a, b in _leaf_pairs(got, ref):
        n += 1
        equal += bool(torch.equal(a, b))
        a, b = a.float().ravel(), b.float().ravel()
        if name in zero:
            noise[name] = max(a.abs().max().item(), b.abs().max().item()) \
                / scales[zero[name]]
            if noise[name] > ZERO_GRAD_REL:
                fail(f'{what}: {name}, 0 in exact arithmetic, is '
                     f'{noise[name]:.4f} of max|g| of {zero[name]} (gate '
                     f'{ZERO_GRAD_REL})')
            continue
        scale = b.abs().max().item()
        if scale == 0.0:
            if a.abs().max().item() != 0.0:
                fail(f'{what}: {name} has a gradient where the reference '
                     'has none')
            continue
        cos = (a @ b / (a.norm() * b.norm())).item()
        rel = (a - b).abs().max().item() / scale
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
        if cos < min_cos or rel > max_rel:
            fail(f'{what}: {name} cosine {cos:.6f} (gate {min_cos}), max '
                 f'rel err {rel:.4f} (gate {max_rel})')
    log(f'{what}: {n} leaves, min cosine {worst_cos:.6f} (gate {min_cos}), '
        f'max|err|/max|g| {worst_rel:.5f} (gate {max_rel}), bit-equal '
        f'{equal} of {n}' + (f'; zero in exact arithmetic: {noise} of the '
                             f'scale of {zero} (gate {ZERO_GRAD_REL})'
                             if zero else ''))
    return {'min_cos': worst_cos, 'max_rel': worst_rel, 'bit_equal': equal,
            'leaves': n, **({'zero_noise': noise} if zero else {})}


def check_grads(model, plm_cls, what=''):
    """Every leaf's gradient of one masked-LM step at full depth on a 4k
    batch: kernels vs plain versions, and remat='full' vs none."""
    batch, _ = train_batch(SMALL_BUDGET, model)
    plm = plm_cls(model)
    loss, grads = plm._grad_step(batch)
    with plain_versions():
        loss_p, grads_p = plm._grad_step(batch)
    model.checkpointing = True
    try:
        loss_c, grads_c = plm._grad_step(batch)
    finally:
        model.checkpointing = False
    L = model.config.num_layers
    cfg = model.config
    zero = {'layers.attn.k.bias': 'layers.attn.k.kernel'} \
        if cfg.bias and not cfg.rotary else None
    log(f'{what}{L} layers, {int(batch.cu_lens[-1])} tokens: loss with '
        f'kernels {loss.item():.6f}, plain versions {loss_p.item():.6f}, '
        f'remat {loss_c.item():.6f}')
    checks = {
        'vs_plain': compare_grads(grads, grads_p, GRAD_MIN_COS, GRAD_MAX_REL,
                                  f'{what}gradients, kernels vs plain '
                                  'versions', zero),
        'remat_vs_none': compare_grads(grads_c, grads, REMAT_MIN_COS,
                                       REMAT_MAX_REL,
                                       f"{what}gradients, remat='full' vs "
                                       'none'),
        'loss': loss.item(), 'loss_plain': loss_p.item(),
    }
    if not torch.equal(loss, loss_c):
        fail(f"{what}remat='full' changed the loss: {loss_c.item()} vs "
             f'{loss.item()}')
    del plm, grads, grads_p, grads_c
    torch.cuda.empty_cache()
    return checks


def check_fit(model, plm_cls):
    """``MaskedPLM(model).fit(MaskedFastaTokenDataset(...))`` over a FASTA
    file written from seed 0: two batches, two steps."""
    from esme_tpu_torch import Alphabet, MaskedFastaTokenDataset
    from esme_tpu_torch.fasta import write_fai
    aa = np.array(list('LAGVSERTIDPKQNFYMHWC'))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'train.fa')
        total, nseq = 0, 0
        with open(path, 'w') as f:
            while total < 1.5 * FIT_BUDGET:
                n = int(rng.integers(100, 1000))
                seq = ''.join(rng.choice(aa, n))
                f.write(f'>seq{nseq}\n')
                for lo in range(0, n, 60):
                    f.write(seq[lo:lo + 60] + '\n')
                total += n + 2
                nseq += 1
        write_fai(path)
        ds = MaskedFastaTokenDataset(path, token_per_batch=FIT_BUDGET,
                                     shuffle=True, random_state=0,
                                     alphabet=Alphabet)
        if len(ds) != 2:
            fail(f'fit: the FASTA file gave {len(ds)} batches, not 2')
        history = plm_cls(model, learning_rate=1e-4).fit(ds, log_every=1)
    log(f'fit over {nseq} sequences ({total} tokens) in {len(ds)} batches '
        f'of {FIT_BUDGET}: losses {history}')
    if len(history) != 2 or not all(np.isfinite(history)):
        fail(f'fit: losses {history}')
    torch.cuda.empty_cache()
    return history


def op_run(fn, xs, w):
    """``fn(*xs)`` and the gradients of ``<fn(*xs), w>``, with the launch
    counters set to 0 just before and read just after."""
    xs = [x.clone().requires_grad_() for x in xs]
    torch.cuda.synchronize()
    reset_counters()
    o = fn(*xs)
    o.backward(w)
    torch.cuda.synchronize()
    return o.detach(), [x.grad for x in xs], read_counters()


def expected_launches(**counts):
    """Every counter at 0 but those given."""
    return {**{name: 0 for name in _counters()}, H9_NAME: 0, H10_NAME: 0,
            'rope_inverse': 0, **counts}


def expect_launches(what, got, **expected):
    want = expected_launches(**expected)
    if got != want:
        fail(f'{what}: launches {got}, not {want}')


def check_op_api(cu, dev):
    """Phase 6: each op of the attention API at the main shape against
    the same op through the plain versions (see the module docstring).
    Returns per op its launches and errors."""
    from esme_tpu_torch.ops import flash, fused_attn, headsplit
    from esme_tpu_torch.ops.flash_v2 import fwd_v2
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H
    q, k, v, seg, pos, spans = flash_inputs(cu, BUDGET, H, D, dev, 11)
    T = q.shape[0]
    cos, sin = rotary_cos_sin(pos, D)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    w = randn(q.shape, gen, dev)
    layouts = {
        'thd': lambda x: x.view(T, H, D),
        'htd': lambda x: x.view(T, H, D).transpose(0, 1).contiguous(),
        'hdt': lambda x: x.view(T, H, D).permute(1, 2, 0).contiguous()}
    results = {}

    def against_plain(name, fn, layout, **expected):
        xs = [layouts[layout](x) for x in (q, k, v)]
        wl = layouts[layout](w)
        o, g, launches = op_run(fn, xs, wl)
        expect_launches(name, launches, **expected)
        with plain_versions():
            o_p, g_p, _ = op_run(fn, xs, wl)
        e_o, share_o = o_errors(o, o_p)
        errs, shares, finite = grad_errors(g, g_p)
        ok = share_o <= 1.0 and max(shares) <= 1.0 and finite
        log(f'{name} at T={T} H={H} D={D}: launches {launches}; '
            f'max|o-plain| {e_o:.3e} ({share_o:.3f} of the H1 gate), '
            f'max|g-plain| {max(errs):.3e} ({max(shares):.3f} of the H2 '
            f'gate), finite {finite} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{name} disagrees with its plain version')
        results[name] = {'launches': launches, 'o_max_abs_err': e_o,
                         'o_gate_share': share_o,
                         'grad_max_abs_err': max(errs),
                         'grad_gate_share': max(shares)}

    against_plain('flash_segment_attention thd',
                  lambda q, k, v: flash.flash_segment_attention(q, k, v, seg),
                  'thd', **{H1_NAME: 1, H2_NAME: 1})
    against_plain('flash_segment_attention htd',
                  lambda q, k, v: flash.flash_segment_attention(
                      q, k, v, seg, layout='htd'),
                  'htd', **{H1_NAME: 1, H2_NAME: 1, H4_NAME: 4})
    against_plain('flash_tm', lambda q, k, v: flash.flash_tm(q, k, v, seg),
                  'hdt', **{H1_NAME: 1, H2_NAME: 1, H4_NAME: 4})

    # split_heads_rotary -> merge_heads: relayouts only, so bit-equal to
    # the plain versions, values and gradients; the merged q and k are
    # H3's rotation of the same rows
    def split_merge(q2, k2, v2):
        parts = headsplit.split_heads_rotary(q2, k2, v2, cos, sin, H)
        return torch.stack([headsplit.merge_heads(p) for p in parts])

    w3 = randn((3, T, H * D), gen, dev)
    o, g, launches = op_run(split_merge, (q, k, v), w3)
    expect_launches('split_heads_rotary -> merge_heads', launches,
                    **{H4_NAME: 8})
    with plain_versions():
        o_p, g_p, _ = op_run(split_merge, (q, k, v), w3)
    qr, kr = headsplit.rotary_qk(q, k, cos, sin, H)
    same = torch.equal(o, o_p) and all(map(torch.equal, g, g_p))
    same_h3 = torch.equal(o[0], qr) and torch.equal(o[1], kr) \
        and torch.equal(o[2], v)
    log(f'split_heads_rotary -> merge_heads at T={T}: launches {launches}; '
        f'values and gradients bit-equal to the plain versions {same}, '
        f'merged q and k bit-equal to H3 {same_h3} (gate: bit equality) '
        f'{"ok" if same and same_h3 else "FAIL"}')
    if not (same and same_h3):
        fail('split_heads_rotary -> merge_heads is not bit-equal')
    results['split_heads_rotary -> merge_heads'] = {
        'launches': launches, 'bit_equal': same, 'bit_equal_h3': same_h3}

    # fwd_v2 (H4, H1, H4) against H1 on the (T, H·D) layout
    qh, kT, vT = layouts['htd'](q), layouts['hdt'](k), layouts['hdt'](v)
    torch.cuda.synchronize()
    reset_counters()
    o, lse = fwd_v2(qh, kT, vT, seg.view(T, 1), seg.view(1, T), *spans[:2],
                    block_q=flash.BLOCK_Q, block_k=flash.BLOCK_K,
                    head_block=H, scale=D ** -0.5, interpret=False)
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches('fwd_v2', launches, **{H1_NAME: 1, H4_NAME: 2})
    o_r, lse_r = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H,
                                         scale=D ** -0.5)
    e_o, share, e_l = flash_errors(o.transpose(0, 1).reshape(T, H * D),
                                   lse[..., 0], o_r, lse_r)
    ok = share <= 1.0 and e_l <= FLASH_LSE_ATOL
    log(f'fwd_v2 at T={T}: launches {launches}; vs segment_flash_fwd '
        f'max|o| {e_o:.3e} ({share:.3f} of the H1 gate), max|lse| '
        f'{e_l:.3e} (gate {FLASH_LSE_ATOL}) {"ok" if ok else "FAIL"}')
    if not ok:
        fail('fwd_v2 disagrees with segment_flash_fwd')
    results['fwd_v2'] = {'launches': launches, 'o_max_abs_err': e_o,
                         'o_gate_share': share, 'lse_max_abs_err': e_l}

    # JAX's ESME_FLASH_IMPL=v2 steps against fused_rotary_flash's forward
    # (H3, H1): the same rotation and the same H1 on copies of the bits
    torch.cuda.synchronize()
    reset_counters()
    _, _, o_d, lse_d = fused_attn._forward(q, k, v, cos, sin, seg, H, spans)
    torch.cuda.synchronize()
    expect_launches('fused_rotary_flash', read_counters(),
                    **{H1_NAME: 1, H3_NAME: 1})
    reset_counters()
    qh, kT, vT = headsplit._split_call_t(q, k, v, cos, sin, H)
    o, lse = fwd_v2(qh, kT, vT, seg.view(T, 1), seg.view(1, T), *spans[:2],
                    block_q=flash.BLOCK_Q, block_k=flash.BLOCK_K,
                    head_block=H, scale=D ** -0.5, interpret=False)
    o = headsplit._merge_call(o, None, None, False, False)
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches('_split_call_t -> fwd_v2 -> _merge_call', launches,
                    **{H1_NAME: 1, H4_NAME: 4})
    e_o, share, e_l = flash_errors(o, lse.view(H, T), o_d, lse_d)
    same = torch.equal(o, o_d)
    ok = share <= 1.0 and e_l <= FLASH_LSE_ATOL
    log(f'_split_call_t -> fwd_v2 -> _merge_call at T={T}: launches '
        f'{launches}; vs fused_rotary_flash max|o| {e_o:.3e} ({share:.3f} '
        f'of the H1 gate), max|lse| {e_l:.3e} (gate {FLASH_LSE_ATOL}), '
        f'bit-equal o {same} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('the v2 steps disagree with fused_rotary_flash')
    results['v2 steps'] = {
        'launches': launches, 'o_max_abs_err': e_o, 'o_gate_share': share,
        'lse_max_abs_err': e_l, 'bit_equal_o': same}
    del q, k, v, w, w3, o, g, o_p, g_p, o_d, qh, kT, vT
    torch.cuda.empty_cache()
    return results


def ptxas_usage(build_log: str) -> dict:
    """``{(kernel, padded head dim, mode): (registers, stack frame, spill
    stores, spill loads)}`` of the H1/H2 kernels in ``nvcc -Xptxas -v``
    output (H9's and H10's mma.sync kernels, which have no mode:
    ``(kernel, padded head dim)``)."""
    usage, name, frame = {}, None, None
    for line in build_log.splitlines():
        m = re.search(r'Function properties for \S*\d(flash_(?:fwd|fwd_rect|'
                      r'bwd_dq|bwd_dkv|bwd_dq_rect|bwd_dkv_rect)_kernel)'
                      r'I((?:Li\d+E)+)E', line)
        if m:
            name = (m.group(1), *map(int, re.findall(r'Li(\d+)E',
                                                     m.group(2))))
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            frame = tuple(map(int, m.groups()))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name and frame:
            usage[name] = (int(m.group(1)), *frame)
            name = frame = None
    return usage


def check_mode0_ptxas():
    """H1's and H2's production instantiations (mode 0) use the registers
    they used before the ablation modes were added, with no stack frame
    and no spills (``MODE0_REGISTERS``); fail otherwise."""
    from esme_tpu_torch import _build
    usage = {lib: ptxas_usage(_build.build_log(lib))
             for lib, _ in MODE0_REGISTERS}
    for (lib, kernel), regs in MODE0_REGISTERS.items():
        for dp, r in regs.items():
            got = usage[lib].get((kernel, dp, 0))
            if got != (r, 0, 0, 0):
                fail(f'ptxas: {kernel}<{dp}, mode 0> uses (registers, stack, '
                     f'spill stores, spill loads) {got}, not {(r, 0, 0, 0)} '
                     'as before the ablation modes')
        log(f'ptxas: {kernel} mode 0 as before the ablation modes: {regs} '
            'registers, no stack, no spills')


# H1's and H2's Hopper kernels as ptxas reported them in the build of this
# slice's parent (the tree before the token-minor layout and the ablation
# modes were added; nvcc of CUDA 12.9 on the H100 machine): (registers,
# stack frame, spill stores, spill loads) by head dim. Their production
# instantiations (layout or mode 0) must come out unchanged.
SM90_PRODUCTION = {
    ('flash_fwd_sm90', 'flash_fwd_sm90_kernel'): {
        32: (127, 0, 0, 0), 64: (128, 0, 0, 0), 128: (168, 0, 0, 0)},
    ('flash_bwd_sm90', 'bwd_dkv_sm90_kernel'): {
        32: (128, 0, 0, 0), 64: (160, 0, 0, 0), 128: (156, 384, 896, 640)},
    ('flash_bwd_sm90', 'bwd_dq_sm90_kernel'): {
        32: (111, 0, 0, 0), 64: (123, 0, 0, 0), 128: (155, 0, 0, 0)},
}


# H6's modes of H1's Hopper form that spill, with (stack frame, spill
# stores, spill loads) as ptxas reported them (nvcc of CUDA 12.9 on the
# H100 machine): noqk builds its scores by register arithmetic instead of
# a wgmma, which puts the 128-register kernel over its cap (it spills
# about as much with no K read at all). Any other mode, or a larger
# spill, fails.
H6_SPILLS = {'noqk': (24, 24, 36)}


def sm90_ptxas_usage(build_log: str,
                     kernels: str = r'bwd_(?:dkv|dq)|flash_fwd') -> dict:
    """``{(kernel, head dim, *params): (registers, stack frame, spill
    stores, spill loads)}`` of H1's and H2's Hopper kernels in ``nvcc
    -Xptxas -v`` output, ``params`` the template parameters after D: H1's
    layout (0 for H1, 1 for H5) and mode (0 the production kernel, else
    H6's), H2's mode (0 the production pass, else H7's). ``kernels``
    matches the names before ``_sm90_kernel`` (H8's ``stream``: its
    template parameters, layout and cluster size, stand in D's place)."""
    usage, name, frame = {}, None, None
    for line in build_log.splitlines():
        m = re.search(r'Function properties for \S*?\d((?:' + kernels +
                      r')_sm90_kernel)I((?:Li\d+E)+)E', line)
        if m:
            name = (m.group(1), *map(int, re.findall(r'Li(\d+)E',
                                                     m.group(2))))
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            frame = tuple(map(int, m.groups()))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name and frame:
            usage[name] = (int(m.group(1)), *frame)
            name = frame = None
    return usage


def production_key(kernel: str, d: int):
    """The usage key of a Hopper kernel's production instantiation: H1's
    layout and mode 0, H2's mode 0."""
    return (kernel, d, 0, 0) if kernel == 'flash_fwd_sm90_kernel' \
        else (kernel, d, 0)


def check_sm90_ptxas():
    """H1's and H2's Hopper libraries as built: each production
    instantiation at D = 32, 64, 128 with the parent's registers, stack
    and spills (``SM90_PRODUCTION``), at 16 and 24 without stack or
    spills, H5's (H1's kernel, token-minor layout) at
    D = 64 without stack or spills, every H6 mode (H1's kernel at D = 64)
    built without a ``wgmma`` serialisation warning (C7510-C7520) naming
    it and without stack or spills but for ``H6_SPILLS``, and every H7
    mode of both passes at D = 64
    built; fail otherwise. Logs every instantiation's ``ptxas`` line and
    any serialisation warning. Returns per library the usage of all its
    kernels and its warnings."""
    from esme_tpu_torch import _build
    from esme_tpu_torch.tools import decompose_bwd as tdb
    from esme_tpu_torch.tools import flash_variants as tfv
    out = {}
    for lib in ('flash_fwd_sm90', 'flash_bwd_sm90'):
        build_log = _build.build_log(lib)
        usage = sm90_ptxas_usage(build_log)
        for (kernel, d, *p), (regs, *frame) in sorted(usage.items()):
            log(f'ptxas: {lib} {kernel}<D={d}, {", ".join(map(str, p))}>: '
                f'{regs} registers, stack {frame[0]}, spill stores '
                f'{frame[1]}, spill loads {frame[2]}')
        for (name, kernel), want in SM90_PRODUCTION.items():
            if name != lib:
                continue
            for d, usage_d in want.items():
                got = usage.get(production_key(kernel, d))
                if got != usage_d:
                    fail(f'ptxas: {kernel}<D={d}> production uses '
                         f'(registers, stack, spill stores, spill loads) '
                         f'{got}, not {usage_d} as in the parent\'s build')
            log(f'ptxas: {kernel} production as in the parent\'s build: '
                f'{want}')
            for d in PADDED_HEAD_DIMS:
                got = usage.get(production_key(kernel, d))
                if got is None or any(got[1:]):
                    fail(f'ptxas: {kernel}<D={d}> production has a stack '
                         f'frame or spills, or is missing: {got}')
            log(f'ptxas: {kernel} production at D = '
                f'{", ".join(map(str, PADDED_HEAD_DIMS))} (32-column tiles): '
                'no stack, no spills')
        warnings = sorted({line.strip() for line in build_log.splitlines()
                           if re.search(r'C75(1\d|20)\b|wgmma', line)})
        for line in warnings:
            log(f'ptxas: {lib}: {line}')
        if lib == 'flash_fwd_sm90':
            got = usage.get(('flash_fwd_sm90_kernel', 64, 1, 0))
            if got is None or any(got[1:]):
                fail(f'ptxas: H5\'s flash_fwd_sm90_kernel<D=64, token-minor> '
                     f'has a stack frame or spills, or is missing: {got}')
            for mode, name in enumerate(tfv.MODES):
                got = usage.get(('flash_fwd_sm90_kernel', 64, 0, mode))
                want = H6_SPILLS.get(name, (0, 0, 0))
                if mode and (got is None or got[1:] != want):
                    fail(f'ptxas: H6 mode {name} (flash_fwd_sm90_kernel<64, '
                         f'0, {mode}>) has (stack, spill stores, spill loads) '
                         f'{got and got[1:]}, not {want}')
                mangled = f'flash_fwd_sm90_kernelILi64ELi0ELi{mode}EE'
                if any(mangled in line for line in warnings):
                    fail(f'ptxas serialises the wgmma of H6 mode '
                         f'{list(tfv.MODES)[mode]}')
            log(f'ptxas: H6\'s {len(tfv.MODES) - 1} modes at D = 64 built '
                f'without a wgmma serialisation warning, and without stack or '
                f'spills but for {H6_SPILLS}')
        else:
            for kernel in ('bwd_dkv_sm90_kernel', 'bwd_dq_sm90_kernel'):
                built = sorted(p for k, d, p in usage
                               if k == kernel and d == 64)
                if built != list(range(len(tdb.MODES))):
                    fail(f'ptxas: H7\'s {kernel} modes at D = 64: built '
                         f'{built}, not all {len(tdb.MODES)}')
        out[lib] = {'usage': {f'{k} D={d} {p}': u
                              for (k, d, *p), u in sorted(usage.items())},
                    'wgmma_warnings': warnings}
    return out


# H8's Hopper kernels (csrc/probes_sm90.cu) by (layout, cluster size): dma
# alone and in pairs, dma_t
H8_SM90_KERNELS = ((0, 1), (0, 2), (1, 1))


def check_probes_sm90_ptxas():
    """H8's Hopper kernels as built: each of ``H8_SM90_KERNELS`` without a
    stack frame or spills; fail otherwise. Logs their ``ptxas`` lines and
    returns them."""
    from esme_tpu_torch import _build
    usage = sm90_ptxas_usage(_build.build_log('probes_sm90'), 'stream')
    for (kernel, *p), (regs, *frame) in sorted(usage.items()):
        log(f'ptxas: probes_sm90 {kernel}<layout {p[0]}, cluster {p[1]}>: '
            f'{regs} registers, stack {frame[0]}, spill stores {frame[1]}, '
            f'spill loads {frame[2]}')
    for layout, cluster in H8_SM90_KERNELS:
        got = usage.get(('stream_sm90_kernel', layout, cluster))
        if got is None or any(got[1:]):
            fail(f'ptxas: H8\'s stream_sm90_kernel<{layout}, {cluster}> has '
                 f'a stack frame or spills, or is missing: {got}')
    return {f'stream_sm90_kernel layout={layout} cluster={cluster}':
            usage[('stream_sm90_kernel', layout, cluster)]
            for layout, cluster in H8_SM90_KERNELS}


def check_probes(dev, h1, h2, card, h8_ptxas):
    """Phase 8: the probe tools' kernels H5-H8 (see the module docstring).
    ``h1`` and ``h2`` hold phase 7's times of H1 and H2, ``h8_ptxas`` the
    ``ptxas`` lines of H8's Hopper kernels. Returns the probes' entries of
    the kernels line."""
    from esme_tpu_torch.ops import flash
    from esme_tpu_torch.tools import (BWD_SEED, FWD_SEED, attention_batch,
                                      hdt_to_thd, thd_to_hdt)
    from esme_tpu_torch.tools import decompose_bwd as tdb
    from esme_tpu_torch.tools import flash_variants as tfv
    from esme_tpu_torch.tools import fwd_T_experiment as tft
    from esme_tpu_torch.tools import profile_attn as tpa
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H

    def gate(what, c):
        """Log a tool's ``check`` result; fail where it is not ok."""
        vals = ', '.join(f'{k} {v:.3e}' for k, v in c.items() if k != 'ok')
        log(f'{what}: {vals} {"ok" if c["ok"] else "FAIL"}')
        if not c['ok']:
            fail(f'{what}: outside its gate')

    # 8a. each kernel against its plain version on the 8k check batch; H5
    # on its route (the Hopper form at D = 32-128, the mma.sync form at 16,
    # 24 and at a T that is not a multiple of 8), which its counter shows
    for d, h, cut in ((16, 20, 0), (24, 20, 0), (32, 20, 0), (64, 20, 0),
                      (128, 40, 0), (64, 20, 27)):
        b = attention_batch(CHECK_BUDGET, 1, h, d, dev)
        T = b.T - cut
        seg = b.seg[:T].contiguous()
        spans = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
        qT, kT, vT = (thd_to_hdt(x[:T], h) for x in (b.q, b.k, b.v))
        route = tft.fwd_T_route(d, T)
        before = dict(tft.fwd_T.routes)
        got = tft.fwd_T(qT, kT, vT, seg, *spans)
        ref = tft.fwd_T_plain(qT, kT, vT, seg, *spans)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in tft.fwd_T.routes.items()}
        if moved != {n: int(n == route) for n in moved}:
            fail(f'H5 at T={T} D={d} launched {moved}, not once on {route}')
        e_o, share, e_l, ok = tft.flash_errors(*got, *ref)
        gate(f'H5 ({route}) T={T} H={h} D={d} vs plain (H1\'s gates)',
             {'max|o-plain|': e_o, 'o gate share': share,
              'max|lse-plain|': e_l, 'ok': ok})
        if route == 'flash_fwd_sm90':
            o1, lse1 = flash.segment_flash_fwd(
                b.q[:T], b.k[:T], b.v[:T], seg, *spans, h)
            if not (torch.equal(hdt_to_thd(got[0]), o1)
                    and torch.equal(got[1], lse1)):
                fail(f'H5 ({route}) at T={T} D={d} is not bit-equal to H1')
            log(f'H5 ({route}) T={T} H={h} D={d}: bit-equal to H1')
    b8 = attention_batch(CHECK_BUDGET, 1, H, D, dev, grads=True)
    args8 = (b8.q, b8.k, b8.v, b8.seg, *b8.spans[:2], H)
    for library in flash.FWD_ROUTES:       # the Hopper form, then mma.sync
        for mode in tfv.MODES:
            got = tfv.variant_fwd(mode, *args8, library=library)
            gate(f'H6 ({library}) {mode} T={b8.T} vs plain', tfv.check(
                mode, got, tfv.variant_fwd_plain(mode, *args8,
                                                 library=library), library))
            if library == flash.fwd_route(D) and mode == 'baseline' and not \
                    all(map(torch.equal, got, flash.segment_flash_fwd(
                        *args8))):
                fail(f'H6 ({library}) baseline at T={b8.T} is not bit-equal '
                     'to H1')
    lse8, delta8 = tdb.backward_inputs(b8)
    bargs8 = (b8.q, b8.k, b8.v, b8.do, lse8, delta8, b8.seg, *b8.spans, H)
    for library in flash.BWD_ROUTES:       # the Hopper form, then mma.sync
        for kernel in tdb.KERNELS:
            for mode in tdb.MODES:
                got = tdb.bwd_variant(kernel, mode, *bargs8, library=library)
                ref = tdb.bwd_variant_plain(kernel, mode, *bargs8,
                                            library=library)
                gate(f'H7 ({library}) {kernel} {mode} T={b8.T} vs plain',
                     tdb.check(mode, got, ref))
    # H8: each probe, the streaming ones in both forms and dma in both
    # modes, the Hopper forms bit-equal to the cp.async form
    outs8 = {}
    for run, (kernel, plain) in tpa.calls(
            b8, tpa.probe_inputs(b8)).items():
        outs8[run] = kernel()
        gate(f'H8 {run} ({tpa.RUNS[run][1]}) T={b8.T} vs plain',
             tpa.check(run, outs8[run], plain()))
    for run, ref in tpa.SAME_AS.items():
        if not torch.equal(outs8[run], outs8[ref]):
            fail(f'H8 {run} at T={b8.T} is not bit-equal to {ref}')
    log(f'H8 T={b8.T}: {", ".join(tpa.SAME_AS)} bit-equal to their cp.async '
        'form')
    del b8, args8, bargs8, lse8, delta8, outs8
    torch.cuda.empty_cache()

    # 8b. each tool's own run at the main shapes, the launch counters set
    # to 0 just before it and read just after; then its comparisons
    def tool_run(what, name, fn):
        torch.cuda.synchronize()
        reset_counters()
        out = fn()
        torch.cuda.synchronize()
        launches = read_counters()
        log(f'{what}: launches {launches}')
        for n in name if isinstance(name, tuple) else (name,):
            if launches[n] < 1:
                fail(f'{what} did not launch {n}')
        return out, launches

    b = attention_batch(BUDGET, FWD_SEED, H, D, dev)
    ks, ke = b.spans[:2]
    args = (b.q, b.k, b.v, b.seg, ks, ke, H)
    # H5 beside H1: its Hopper form (the route at this shape) against H1's
    # Hopper form on the same values, its plain version and its mma.sync
    # form, which it must beat (fastest of 8 calls each)
    r5, l5 = tool_run('fwd_T_experiment.measure', H5_NAME,
                      lambda: tft.measure(b, reps=20))
    if r5['route'] != 'flash_fwd_sm90':
        fail(f'H5 ran on {r5["route"]} at the main shape, not its Hopper form')
    log(f'H5 ({r5["route"]}) vs H1 ({flash.fwd_route(D)}) at T={b.T}: '
        f'max|o| {r5["o_err_vs_h1"]:.3e} ({r5["o_gate_share_vs_h1"]:.3f} of '
        f'the gate), max|lse| {r5["lse_err_vs_h1"]:.3e}, bit-equal '
        f'{r5["bit_equal_to_h1"]}')
    # bit equality, as the first card run showed at every shape checked: the
    # same products summed in the same order, from operands laid out apart
    if not r5['bit_equal_to_h1']:
        fail('H5 is not bit-equal to H1 at the main shape')
    qT, kT, vT = (thd_to_hdt(x, H) for x in (b.q, b.k, b.v))
    targs = (qT, kT, vT, b.seg, ks, ke)
    ref5 = tft.fwd_T_plain(*targs)
    e_o, share, e_l, ok = tft.flash_errors(*tft.fwd_T(*targs), *ref5)
    gate(f'H5 T={b.T} vs plain', {'max|o-plain|': e_o, 'o gate share': share,
                                 'max|lse-plain|': e_l, 'ok': ok})
    # the mma.sync form, timed below, under H1's gates against the plain
    # version and against H1
    o1, lse1 = flash.segment_flash_fwd(*args)
    oT_m, lse_m = tft.launch_fwd_T('flash_fwd_t', *targs)
    for what, ref in (('plain', ref5), ('H1', (thd_to_hdt(o1, H), lse1))):
        e_m, share_m, e_lm, ok_m = tft.flash_errors(oT_m, lse_m, *ref)
        gate(f'H5 mma.sync form T={b.T} vs {what} (H1\'s gates)',
             {f'max|o-{what}|': e_m, 'o gate share': share_m,
              f'max|lse-{what}|': e_lm, 'ok': ok_m})
    del ref5, oT_m, lse_m
    h5_fastest = fastest_calls(
        f'H5 at T={b.T}',
        {'flash_fwd_sm90': lambda: tft.launch_fwd_T('flash_fwd_sm90', *targs),
         'flash_fwd_t': lambda: tft.launch_fwd_T('flash_fwd_t', *targs)})
    if not h5_fastest['flash_fwd_sm90']['min'] < \
            h5_fastest['flash_fwd_t']['min']:
        fail('H5\'s Hopper form is not faster than its mma.sync form')
    h5_plain_ms = cuda_ms(lambda: tft.fwd_T_plain(*targs), reps=2)
    h5_lib_ms = yardstick(
        'varlen flash-attention forward (aten), (T, H, D) operands',
        lambda: varlen_flash_ms(b.q, b.k, b.v, b.seg, H, D, reps=20), o1)
    log(f'H5 (flash_fwd_sm90) {r5["ms"]:.4f} ms: '
        f'{r5["ms"] / r5["mma_sync_ms"]:.4f} of its mma.sync form '
        f'({r5["mma_sync_ms"]:.4f} ms), {r5["ms"] / r5["h1_ms"]:.4f} of H1 '
        f'({r5["h1_ms"]:.4f} ms), {r5["ms"] / r5["bound_ms"]:.2f}x its bound '
        f'({r5["bound_ms"]:.4f} ms), '
        + (f'{r5["ms"] / h5_lib_ms:.4f} of the varlen library '
           f'({h5_lib_ms:.4f} ms)' if h5_lib_ms else 'no library time'))
    del qT, kT, vT, o1, lse1, targs
    kernels = [{
        'name': H5_NAME, 'route': 'cuda',
        'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
        'form': 'flash_fwd_sm90 (H1\'s kernel, token-minor layout; entry '
                'esme_flash_fwd_t_sm90)',
        'routes': {'D 32-128, T % 8 == 0': 'esme_tpu_torch/csrc/'
                   'flash_fwd_sm90.cu', 'otherwise': 'esme_tpu_torch/csrc/'
                   'flash_fwd_t.cu'},
        'replaces': 'tools/fwd_T_experiment.py:27',
        'launches': l5[H5_NAME], 'max_abs_err': e_o, 'lse_max_abs_err': e_l,
        'ms': r5['ms'], 'plain_ms': h5_plain_ms, 'bound_ms': r5['bound_ms'],
        'bound_by': r5['bound_by'], 'library_ms': h5_lib_ms,
        'mma_sync_form_ms': r5['mma_sync_ms'], 'fastest_ms': h5_fastest,
        'h1_ms': r5['h1_ms'], 'vs_h1': {k: r5[k] for k in (
            'o_err_vs_h1', 'o_gate_share_vs_h1', 'lse_err_vs_h1',
            'bit_equal_to_h1')},
        'shape': f'T={b.T} H={H} D={D} bf16, (H, D, T) operands'}]

    # H6: every mode of both forms timed; the Hopper form's baseline
    # bit-equal to H1, the mma.sync form's to that form, each under its
    # gates against its plain walk; H1 under its gates against the latter
    hopper6, mma_sync6 = flash.fwd_route(D), 'flash_fwd'
    modes6, l6 = tool_run(
        'flash_variants.run, every mode of both forms', H6_NAME,
        lambda: {library: {m: tfv.run(m, b, reps=20, library=library)
                           for m in tfv.MODES}
                 for library in (hopper6, mma_sync6)})
    for library, runs in modes6.items():
        base = runs['baseline']['ms']
        log(f'H6 ({library}) at T={b.T}: ' + ', '.join(
            f'{m} {r["ms"]:.4f} ms ({r["ms"] / base:.3f}; '
            f'{r["ms"] / r["bound_ms"]:.2f}x its bound)'
            for m, r in runs.items()))
    got = tfv.variant_fwd('baseline', *args, library=hopper6)
    if not all(map(torch.equal, got, flash.segment_flash_fwd(*args))):
        fail(f'H6 ({hopper6}) baseline is not bit-equal to H1 at the main '
             'shape')
    c6 = tfv.check('baseline', got, tfv.variant_fwd_plain(
        'baseline', *args, library=hopper6))
    gate(f'H6 ({hopper6}) baseline T={b.T} vs plain (bit-equal to H1)', c6)
    got = tfv.variant_fwd('baseline', *args, library=mma_sync6)
    if not all(map(torch.equal, got, mma_sync_fwd(args))):
        fail('H6 baseline is not bit-equal to the mma.sync form of H1 at the '
             'main shape')
    gate(f'H6 ({mma_sync6}) baseline T={b.T} vs plain (bit-equal to the '
         'mma.sync form)', tfv.check('baseline', got, tfv.variant_fwd_plain(
             'baseline', *args, library=mma_sync6), mma_sync6))
    o, lse = flash.segment_flash_fwd(*args)
    e_o, share, e_l = flash_errors(o, lse, *got)
    gate(f'H1 ({flash.fwd_route(D)}) T={b.T} vs H6 baseline (the mma.sync '
         "form), H1's gates",
         {'max|o-baseline|': e_o, 'o gate share': share,
          'max|lse-baseline|': e_l,
          'ok': share <= 1.0 and e_l <= FLASH_LSE_ATOL})
    del o, lse, got
    h6_plain_ms = {library: cuda_ms(
        lambda library=library: tfv.variant_fwd_plain(
            'baseline', *args, library=library), reps=1)
        for library in (hopper6, mma_sync6)}
    kernels.append({
        'name': H6_NAME, 'route': 'cuda',
        'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
        'form': f'{hopper6} (entry esme_segment_flash_fwd_sm90_variant)',
        'forms': {hopper6: 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
                  mma_sync6: 'esme_tpu_torch/csrc/flash_fwd.cu'},
        'replaces': 'tools/flash_variants.py:32', 'launches': l6[H6_NAME],
        'max_abs_err': c6['o_err'], 'ms': modes6[hopper6]['baseline']['ms'],
        'plain_ms': h6_plain_ms[hopper6],
        'bound_ms': modes6[hopper6]['baseline']['bound_ms'],
        'bound_by': modes6[hopper6]['baseline']['bound_by'],
        'library_ms': None,
        'mode': 'baseline (bit-equal to H1)', 'modes': modes6,
        'h1_ms': h1['ms'],
        'mma_sync_form_ms': modes6[mma_sync6]['baseline']['ms'],
        'mma_sync_form_plain_ms': h6_plain_ms[mma_sync6],
        'shape': f'T={b.T} H={H} D={D} bf16'})

    # H8 probes over H1's steps: every run (the streaming probes in both
    # forms, dma in both modes) under its gate, the Hopper forms bit-equal
    # to the cp.async form; each Hopper form faster than its cp.async form
    # (fastest of 8 calls each, on the card alone)
    r8, l8 = tool_run('profile_attn.measure', H8_NAMES,
                      lambda: tpa.measure(b, reps=20))
    for run in tpa.RUNS:
        if not r8[run]['ok']:
            fail(f'H8 {run} disagrees with its plain version')
    for run, ref in tpa.SAME_AS.items():
        if not r8[run]['bit_equal']:
            fail(f'H8 {run} is not bit-equal to {ref} at the main shape')
    calls8 = tpa.calls(b, tpa.probe_inputs(b))
    plains = {p: cuda_ms(calls8[p][1], reps=2) for p in tpa.PROBES}
    kT8, vT8 = (thd_to_hdt(x, H) for x in (b.k, b.v))
    fastest8 = {
        'dma': fastest_calls(f'H8 dma at T={b.T}', {
            'probes_sm90': lambda: tpa.launch_dma('probes_sm90', b.q, b.k,
                                                  b.v, ks, ke, H),
            'pair': lambda: tpa.launch_dma('probes_sm90', b.q, b.k, b.v, ks,
                                           ke, H, cluster=2),
            'probes': lambda: tpa.launch_dma('probes', b.q, b.k, b.v, ks, ke,
                                             H)}),
        'dma_t': fastest_calls(f'H8 dma_t at T={b.T}', {
            'probes_sm90': lambda: tpa.launch_dma_t('probes_sm90', kT8, vT8,
                                                    ks, ke),
            'probes': lambda: tpa.launch_dma_t('probes', kT8, vT8, ks,
                                               ke)})}
    for probe, fastest in fastest8.items():
        if not fastest['probes_sm90']['min'] < fastest['probes']['min']:
            fail(f'H8 {probe}\'s Hopper form is not faster than its cp.async '
                 'form')
    k3 = b.k.view(b.T, H, D)
    lib_ms = cuda_ms(lambda: k3.permute(1, 2, 0).contiguous(), reps=20,
                     warmup=2)
    for probe, line in zip(tpa.PROBES, (81, 115, 155, 209)):
        r = r8[probe]
        entry = {
            'name': f'probe_{probe}', 'route': 'cuda',
            'source': 'esme_tpu_torch/csrc/probes.cu',
            'replaces': f'tools/profile_attn.py:{line}',
            'launches': l8[f'probe_{probe}'], 'max_abs_err': r['err'],
            'ms': r['ms'], 'plain_ms': plains[probe],
            'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
            'library_ms': lib_ms if probe.startswith('dma') else None,
            'tile_bytes': r['tile_bytes'], 'h1_ms': r8['h1']['ms'],
            'shape': f'T={b.T} H={H} D={D}, H1\'s steps'}
        if probe in fastest8:
            cp = r8[f'{probe}_cp_async']
            entry.update({
                'source': 'esme_tpu_torch/csrc/probes_sm90.cu',
                'forms': {'probes_sm90': 'esme_tpu_torch/csrc/'
                          'probes_sm90.cu',
                          'probes': 'esme_tpu_torch/csrc/probes.cu'},
                'l2_tb_per_s': r['l2_tb_per_s'], 'cp_async_form_ms': cp['ms'],
                'cp_async_l2_tb_per_s': cp['l2_tb_per_s'],
                'cp_async_max_abs_err': cp['err'],
                'bit_equal_to_cp_async': r['bit_equal'],
                'fastest_ms': fastest8[probe], 'ptxas': h8_ptxas})
            if probe == 'dma':
                pair = r8['dma_pair']
                entry.update({
                    'pair_ms': pair['ms'], 'pair_tile_bytes':
                    pair['tile_bytes'], 'pair_l2_tb_per_s':
                    pair['l2_tb_per_s'], 'pair_max_abs_err': pair['err'],
                    'pair_bit_equal_to_cp_async': pair['bit_equal']})
        kernels.append(entry)
        if probe in fastest8:
            log(f'H8 {probe}: ' + '; '.join(
                f'{run} {r8[run]["ms"]:.4f} ms, tiles '
                f'{r8[run]["tile_bytes"] / 1e9:.3f} GB'
                + ('' if r8[run]['l2_tb_per_s'] is None else
                   f' at {r8[run]["l2_tb_per_s"]:.3f} TB/s')
                for run in tpa.RUNS if tpa.RUNS[run][0] == probe)
                + f'; bound {r["bound_ms"]:.4f} ms by {r["bound_by"]}')
    del b, args, k3, kT8, vT8, calls8
    torch.cuda.empty_cache()

    # H7 at the train shape: every mode of each pass of both forms timed;
    # the Hopper form's real bit-equal to H2 and as fast as H2's own passes;
    # the mma.sync form's real bit-equal to that form and under H2's gate
    bt = attention_batch(BUDGET, BWD_SEED, H, D, dev, grads=True)
    lse, delta = tdb.backward_inputs(bt)
    bargs = (bt.q, bt.k, bt.v, bt.do, lse, delta, bt.seg, *bt.spans, H)
    hopper, mma_sync = flash.BWD_ROUTES
    modes7, l7 = tool_run(
        'decompose_bwd.run, every mode of each pass of both forms', H7_NAME,
        lambda: {library: {f'{kernel} {mode}': tdb.run(
            kernel, mode, bt, lse, delta, reps=20, library=library)
            for kernel in tdb.KERNELS for mode in tdb.MODES}
            for library in (hopper, mma_sync)})
    for kernel in tdb.KERNELS:
        real = modes7[hopper][f'{kernel} real']['ms']
        log(f'H7 ({hopper}) {kernel} at the train shape: '
            + ', '.join(f'{mode} {r["ms"]:.4f} ms ({r["ms"] / real:.3f}; '
                        f'{r["ms"] / r["bound_ms"]:.2f}x its bound)'
                        for mode, r in ((m, modes7[hopper][f'{kernel} {m}'])
                                        for m in tdb.MODES)))
    got = (tdb.bwd_variant('dq', 'real', *bargs, library=hopper),
           *tdb.bwd_variant('dkv', 'real', *bargs, library=hopper))
    if not all(map(torch.equal, got, flash.segment_flash_bwd(*bargs))):
        fail('H7 real (the Hopper form) is not bit-equal to H2 at the train '
             'shape')
    plain_dq = lambda: tdb.bwd_variant_plain(  # noqa
        'dq', 'real', *bargs, library=hopper)
    plain_dkv = lambda: tdb.bwd_variant_plain(  # noqa
        'dkv', 'real', *bargs, library=hopper)
    c7 = tdb.check('real', got, (plain_dq(), *plain_dkv()))
    gate(f'H7 ({hopper}) real T={bt.T} vs plain (bit-equal to H2)', c7)
    h7_plain_ms = cuda_ms(plain_dq, reps=1) + cuda_ms(plain_dkv, reps=1)
    # mode 0 is H2's own pass: each timed beside H2's launch of it, in turn
    h7_vs_h2 = {kernel: {side: t['min'] for side, t in fastest_calls(
        f'H7 real ({hopper}) {kernel} vs H2\'s pass', {
            'h2': lambda which=which: sm90_pass(which, bargs),
            'h7': lambda kernel=kernel: tdb.bwd_variant(
                kernel, 'real', *bargs, library=hopper)}).items()}
        for which, kernel in enumerate(tdb.KERNELS)}
    ratio = sum(x['h7'] for x in h7_vs_h2.values()) / \
        sum(x['h2'] for x in h7_vs_h2.values())
    within = abs(ratio - 1) <= 0.03
    log(f'H7 real ({hopper}) vs H2\'s passes at the train shape: '
        f'{h7_vs_h2}, {ratio:.4f} (within 3%: {within}; '
        f'{"a gate" if card == REF_CARD else "logged only"} on {card}); H2 '
        f'both passes in one call {h2["ms"]:.4f} ms')
    if card == REF_CARD and not within:
        fail(f'H7 real ({hopper}) took {ratio:.4f} of H2\'s passes')
    real = [modes7[hopper][f'{k} real'] for k in tdb.KERNELS]
    kernels.append({
        'name': H7_NAME, 'route': 'cuda',
        'source': 'esme_tpu_torch/csrc/flash_bwd_sm90.cu',
        'form': f'{hopper} (entry esme_flash_bwd_sm90_pass)',
        'replaces': 'tools/decompose_bwd.py:66',
        'also_replaces': ['tools/decompose_bwd.py:125'],
        'launches': l7[H7_NAME], 'max_abs_err': c7['err'],
        'ms': sum(r['ms'] for r in real), 'plain_ms': h7_plain_ms,
        'bound_ms': sum(r['bound_ms'] for r in real),
        'bound_by': max(real, key=lambda r: r['bound_ms'])['bound_by'],
        'library_ms': None,
        'mode': 'real (dk/dv + dq, bit-equal to H2)', 'modes': modes7,
        'h2_ms': h2['ms'], 'h2_passes_ms': h7_vs_h2,
        'mma_sync_form_ms': sum(modes7[mma_sync][f'{k} real']['ms']
                                for k in tdb.KERNELS),
        'shape': f'T={bt.T} H={H} D={D} bf16 (train batch)'})

    # the mma.sync form's real: bit-equal to that form, H2 under its gate
    # against it, its time held to before the modes were added
    dq = tdb.bwd_variant('dq', 'real', *bargs, library=mma_sync)
    dk, dv = tdb.bwd_variant('dkv', 'real', *bargs, library=mma_sync)
    if not all(map(torch.equal, (dq, dk, dv), mma_sync_bwd(bargs))):
        fail('H7 real is not bit-equal to the mma.sync form of H2 at the '
             'train shape')
    errs, shares, finite = grad_errors(flash.segment_flash_bwd(*bargs),
                                       (dq, dk, dv))
    ok = max(shares) <= 1.0 and finite
    log(f'H2 (the Hopper form) vs H7 real (the mma.sync form) T={bt.T}: '
        f'max|diff| {max(errs):.3e}, {max(shares):.3f} of the H2 gate, '
        f'finite {finite} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('H2 disagrees with H7 real, its mma.sync form')
    del bt, bargs, dq, dk, dv, lse, delta, got
    torch.cuda.empty_cache()
    h7_times = (h2['mma_sync_ms'], sum(modes7[mma_sync][f'{k} real']['ms']
                                       for k in tdb.KERNELS))
    for name, timings, ref in (
            (f'{H1_NAME}, the mma.sync form',
             (h1['mma_sync_ms'], modes6[mma_sync6]['baseline']['ms']),
             H1_REF_MS),
            (f'{H7_NAME} real (the mma.sync form of H2)', h7_times,
             H2_REF_MS)):
        ratio = min((t / ref for t in timings), key=lambda x: abs(x - 1))
        within = abs(ratio - 1) <= 0.03
        log(f'{name} {" and ".join(f"{t:.4f}" for t in timings)} ms, best '
            f'{ratio:.4f} of its {ref} ms before the ablation modes on '
            f'{REF_CARD} (within 3%: {within}; '
            f'{"a gate" if card == REF_CARD else "logged only"} on {card})')
        if card == REF_CARD and not within:
            fail(f'{name} moved by more than 3% from {ref} ms')
    h7_ms = min(h7_times)
    lib = h2['library_ms']
    log(f'{H2_NAME} (the Hopper form) {h2["ms"]:.4f} ms at the train shape: '
        f'{h2["ms"] / h7_ms:.4f} of H7 real ({h7_ms:.4f} ms, the mma.sync '
        f'form), '
        + (f'{h2["ms"] / lib:.4f} of the library ({lib:.4f} ms)' if lib
           else 'no library time'))
    if not h2['ms'] < h7_ms:
        fail(f'H2 ({h2["ms"]:.4f} ms) is not faster than its mma.sync form '
             f'({h7_ms:.4f} ms)')
    return kernels


def time_relayouts(T, H, D, dev, card):
    """H4 in each mode at the main shape on the route its rule picks,
    held bit-equal to its plain version: ms beside its bound (bytes: each
    tensor read and written once and, where a tensor rotates, the halves
    ``[:, :D/2]`` of the cos and sin tables that H4 and its plain version
    read, once), its plain version's ms and, for a move of one tensor
    without rotation, one ``permute(...).contiguous()`` call's ms. A mode
    with an hdt side (the vec route at this T) is also timed on the tile
    kernel, its route where T % 8 != 0, in turn with the vec kernel
    (``fastest_calls``, the card alone), after the tile kernel's output
    too is held bit-equal to the plain version: the vec kernel's fastest
    call must be faster where the move rotates, and where it does not,
    within 3% of the tile kernel's fastest call (its ratio to the tile
    kernel's earlier times, ``H4_TILE_REF_MS``, is logged). A 20-call mean of a 0.1 ms
    move through the checking wrapper can hold host time between the
    launches, so the gates read the card alone."""
    from esme_tpu_torch.ops import headsplit
    order = {'thd': (0, 1, 2), 'htd': (1, 0, 2), 'hdt': (1, 2, 0)}
    modes = {}
    for mode in RELAYOUTS:
        args = relayout_args(mode, T, H, D, dev, seed=3)
        xs, src, dst, _, rot, cos, sin = args
        route = headsplit.relayout_route(src, dst, T)
        got = headsplit.relayout_heads(*args)
        ref = headsplit.relayout_heads_plain(*args)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, ref))
        if not all(map(torch.equal, got, ref)):
            fail(f'H4 {mode} at T={T} H={H} D={D} differs from its plain '
                 f'version by up to {err:.3e} (gate: bit equality)')
        ms = cuda_ms(lambda: headsplit.relayout_heads(*args), reps=20,
                     warmup=2)
        plain_ms = cuda_ms(lambda: headsplit.relayout_heads_plain(*args),
                           reps=3)
        rotates = any(rot)
        nbytes = 2 * sum(x.numel() * x.element_size() for x in xs) \
            + (cos.numel() * cos.element_size() if rotates else 0)
        flops = 6.0 * xs[0].numel() * sum(map(bool, rot))
        b, by = bound(nbytes, flops, FP32_FLOP_PER_S)
        lib = None
        if len(xs) == 1 and not rotates:
            view = headsplit._thd_view(xs[0], src, H).permute(*order[dst])
            if not torch.equal(view.contiguous().view(got[0].shape), got[0]):
                fail(f'H4 {mode}: the library yardstick computes another '
                     'function')
            lib = cuda_ms(lambda: view.contiguous(), reps=20, warmup=2)
        modes[mode] = {'route': route, 'ms': ms, 'plain_ms': plain_ms,
                       'bound_ms': b, 'bound_by': by, 'library_ms': lib,
                       'bytes': nbytes, 'max_abs_err': err}
        log(f'H4 {mode} at T={T} H={H} D={D} ({route}): {ms:.4f} ms (bound '
            f'{b:.4f} ms by {by}, {ms / b:.2f}x), plain {plain_ms:.3f} ms, '
            f'library {lib}, max|err| {err}')
        if route == 'vec':
            tile = headsplit.launch_relayout('tile', *args)
            torch.cuda.synchronize()
            if not all(map(torch.equal, tile, ref)):
                e = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(tile, ref))
                fail(f'H4 {mode} (tile) at T={T} H={H} D={D} differs from '
                     f'its plain version by up to {e:.3e} (gate: bit '
                     'equality)')
            del tile
            fastest = fastest_calls(f'H4 {mode}, vec vs tile kernel', {
                r: lambda r=r: headsplit.launch_relayout(r, *args)
                for r in ('vec', 'tile')})
            vec, tile = fastest['vec']['min'], fastest['tile']['min']
            modes[mode]['fastest'] = fastest
            log(f'H4 {mode}: the tile kernel bit-equal to the plain version '
                f'too; fastest calls vec {vec:.4f} ms ({vec / b:.2f}x its '
                f'bound), tile {tile:.4f} ms ({tile / b:.2f}x), vec/tile '
                f'{vec / tile:.4f}')
            if rotates and not vec < tile:
                fail(f'H4 {mode}: the vec kernel ({vec:.4f} ms) is not '
                     f'faster than the tile kernel ({tile:.4f} ms)')
            if not rotates:
                ref_ms = H4_TILE_REF_MS[mode]
                log(f'H4 {mode}: vec {vec / ref_ms:.4f} of the tile '
                    f'kernel\'s earlier {ref_ms} ms on {REF_CARD} (logged '
                    f'only; this card: {card})')
                if not vec <= 1.03 * tile:
                    fail(f'H4 {mode}: the vec kernel took {vec / tile:.4f} '
                         'of the tile kernel\'s time in this run (gate: '
                         'within 3%)')
        del args, xs, got, ref
        torch.cuda.empty_cache()
    return modes


# ---------------------------------------------------------------------------
# Phase 12: every ESM2 size on the card
# ---------------------------------------------------------------------------

# The ESM2 sizes beside phase 4's 650M (esme_tpu_torch/models/config.py:
# ESM2_SIZES), bf16, seed-0 random weights, each freed before the next:
# (name, the TRAIN_CELLS it trains in). 3B's nockpt@10k fits one 80 GB
# card (37.8 GiB at its peak on the H100); 15B runs inference only: its
# training needs an optimizer offload or more cards.
SIZE_RUNS = (
    ('esm2_8m', ('nockpt', 'ckpt')),
    ('esm2_35m', ('nockpt', 'ckpt')),
    ('esm2_150m', ('nockpt',)),
    ('esm2_3b', ('nockpt',)),
    ('esm2_15b', ()),
)
# Timed steps of a size's cell where phase 5's count is too few for its
# losses to fall: 3B's fresh Adam (lr·sign(g) on 2.8 billion weights)
# raises the loss at the third step, and six steps ended above the first
# on the H100 (3.7815, 3.7091, 5.5828, 5.0666, 4.4764, 4.0110).
SIZE_TRAIN_REPS = {('esm2_3b', 'nockpt'): 10}
# H1's and H2's head dims in those sizes, each timed at its size's head
# count on the 50k inference and train batches (64 at 20 heads is phase
# 7's). At the padded head dims the Hopper form, where it is the route,
# must beat the mma.sync form there.
SIZE_HEAD_DIMS = ((16, 20), (24, 20), (32, 20), (128, 40))
PADDED_HEAD_DIMS = (16, 24)


def exp_bound(nbytes: float, flops: float, exps: float):
    """The least time of a flash kernel's work with its exponentials at
    the SFU's rate as a third term: ``(ms, 'bytes' or 'operations', what
    binds: 'bytes', 'tensor cores' or 'exps')``."""
    t = {'bytes': nbytes / HBM_BYTES_PER_S,
         'tensor cores': flops / BF16_FLOP_PER_S,
         'exps': exps / SFU_EXP_PER_S}
    binds = max(t, key=t.get)
    return t[binds] * 1e3, 'bytes' if binds == 'bytes' else 'operations', \
        binds


def time_head_dim(D, H, cu, tcu, dev):
    """Phase 12's kernel times at head dim D with H heads: H1 on the 50k
    inference batch (``cu``) and H2 on the 50k train batch (``tcu``), each
    first held against its plain version on its route and on the other
    form (``check_flash_args``, ``check_bwd_args``); then the route's
    wrapper, both forms through their C entries, H2's Hopper passes alone,
    the plain version, the varlen library call (a yardstick, its ratio
    logged) and the bound with its exps (one per same-segment pair and
    head in H1, two in H2, where both passes recompute P). Fails where D
    is a padded head dim whose route is the Hopper form and that form is
    not faster than the mma.sync form. Returns ``{H1_NAME: row, H2_NAME:
    row}``."""
    from esme_tpu_torch.ops import flash
    out = {}
    q, k, v, seg, _, spans = flash_inputs(cu, BUDGET, H, D, dev, D + 300)
    args = (q, k, v, seg, *spans[:2], H)
    route = flash.fwd_route(D)
    e_o, e_l, o, _ = check_flash_args(args, ' at the main shape')
    for lib in flash.FWD_ROUTES:
        if lib != route:
            check_flash_args(args, ' at the main shape', library=lib)
    ms = cuda_ms(lambda: flash.segment_flash_fwd(*args), reps=20, warmup=2)
    forms = {lib: cuda_ms(lambda: flash.launch_fwd(lib, *args), reps=20,
                          warmup=2) for lib in flash.FWD_ROUTES}
    plain_ms = cuda_ms(lambda: flash.segment_flash_fwd_plain(*args), reps=2)
    nbytes, flops = flash_work(q, seg, spans[0], H, D)
    b_ms, by, binds = exp_bound(nbytes, flops, flops / (4 * D))
    lib_ms = yardstick(f'varlen flash-attention forward (aten) D={D}',
                       lambda: varlen_flash_ms(q, k, v, seg, H, D, reps=20),
                       o)
    out[H1_NAME] = {'route': route, 'ms': ms, 'forms_ms': forms,
                 'max_abs_err': e_o, 'lse_max_abs_err': e_l,
                 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': by,
                 'bound_binds': binds, 'library_ms': lib_ms,
                 'shape': f'T={q.shape[0]} H={H} D={D} bf16',
                 'bytes': nbytes, 'flops': flops}
    del q, k, v, o, args
    q, k, v, do, lse, delta, tseg, tspans = bwd_inputs(tcu, BUDGET, H, D,
                                                       dev, D + 400)
    inputs = (q, k, v, do, lse, delta, tseg, tspans)
    h2_args = (q, k, v, do, lse, delta, tseg, *tspans, H)
    broute = flash.bwd_route(D)
    err, share = check_bwd_args(inputs, H, D, ' at the train shape')
    for lib in flash.BWD_ROUTES:
        if lib != broute:
            check_bwd_args(inputs, H, D, ' at the train shape', library=lib)
    dq = flash.segment_flash_bwd(*h2_args)[0]
    bms = cuda_ms(lambda: flash.segment_flash_bwd(*h2_args), reps=20,
                  warmup=2)
    bforms = {lib: cuda_ms(lambda: flash.launch_bwd(lib, *h2_args), reps=20,
                           warmup=2) for lib in flash.BWD_ROUTES}
    passes = {name: cuda_ms(lambda: sm90_pass(which, h2_args), reps=20,
                            warmup=2)
              for which, name in ((0, 'dkv'), (1, 'dq'))}
    bplain_ms = cuda_ms(lambda: flash.segment_flash_bwd_plain(*h2_args),
                        reps=1)
    bbytes, bflops = flash_bwd_work(q, tseg, tspans, H, D)
    bb_ms, bby, bbinds = exp_bound(bbytes, bflops, 2 * bflops / (10 * D))
    blib_ms = yardstick(f'varlen flash-attention backward (aten) D={D}',
                        lambda: varlen_flash_bwd_ms(q, k, v, do, tseg, H, D,
                                                    reps=20), dq, 'H2 dq')
    out[H2_NAME] = {'route': broute, 'ms': bms, 'forms_ms': bforms,
                 'sm90_passes_ms': passes, 'max_abs_err': err,
                 'gate_share': share, 'plain_ms': bplain_ms,
                 'bound_ms': bb_ms, 'bound_by': bby, 'bound_binds': bbinds,
                 'library_ms': blib_ms,
                 'shape': f'T={q.shape[0]} H={H} D={D} bf16 (train batch)',
                 'bytes': bbytes, 'flops': bflops}
    del q, k, v, do, dq, inputs, h2_args
    torch.cuda.empty_cache()
    for name, row, sm90, mma in (('H1', out[H1_NAME], 'flash_fwd_sm90',
                                  'flash_fwd'),
                                 ('H2', out[H2_NAME], 'flash_bwd_sm90',
                                  'flash_bwd')):
        f = row['forms_ms']
        lib = row['library_ms']
        log(f'{name} D={D} H={H} ({row["shape"]}): {row["ms"]:.4f} ms on its '
            f'route ({row["route"]}); Hopper form {f[sm90]:.4f} ms, mma.sync '
            f'form {f[mma]:.4f} ms ({f[sm90] / f[mma]:.4f}); bound '
            f'{row["bound_ms"]:.4f} ms by {row["bound_binds"]} '
            f'({row["ms"] / row["bound_ms"]:.2f}x); plain '
            f'{row["plain_ms"]:.3f} ms; varlen library '
            + (f'{lib:.4f} ms ({row["ms"] / lib:.4f}; logged, not a gate)'
               if lib else 'did not run'))
        if D in PADDED_HEAD_DIMS and row['route'] == sm90 \
                and not f[sm90] < f[mma]:
            fail(f'{name}\'s Hopper form ({f[sm90]:.4f} ms) is not faster '
                 f'than its mma.sync form ({f[mma]:.4f} ms) at D={D}, the '
                 'main shape')
    return out


def check_size(name, trains, dev, plm_cls, batch, profile_dir=None):
    """One ESM2 size of phase 12 (``SIZE_RUNS``): built on the card from
    seed 0 (its init time and peak memory logged), then phase 4's
    inference cell on the main ``batch`` (launches exact, then the 4k
    comparisons ahead of the timed forwards) and the ``trains`` cells of
    phase 5, each with phase 5's gates, and every leaf's gradient against
    the plain versions and with remat; ``--profile`` tables of the
    inference and train cells under ``profile_dir/<name>``. The model is
    freed at the end. Returns the size's measurements."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.models.config import ESM2_SIZES
    cfg = ESM2_SIZES[name]
    L, H = cfg['num_layers'], cfg['attention_heads']
    D = cfg['embed_dim'] // H
    prof = os.path.join(profile_dir, name) if profile_dir else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ESM2(**cfg, dtype='bfloat16', rng=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in _leaves(model.params))
    log(f'{name} {cfg} (D = {D}) init on the card: {init_s:.1f} s, '
        f'{n_params:,} params, peak memory {init_peak:.2f} GiB')
    what = f'{name} inference'
    out = {'config': cfg, 'head_dim': D, 'params': n_params,
           'init_s': init_s, 'init_peak_mem_gib': init_peak,
           'launches': inference_run(model, batch, what, expected_launches(
               **{H1_NAME: L, H3_NAME: L})),
           'model_checks': plain_checks(model, f'{name} ')}
    out.update(inference_times(model, batch, what))
    if prof:
        tokens, cu, max_len = batch
        _profile(lambda: model.predict_log_prob(tokens,
                                                pad_args=(cu, max_len)),
                 prof, 'profile_main.txt', f'{name} forward')
    if name in SIZE_QUANTIZE:
        out['quantized'] = quantized_size(model, SIZE_QUANTIZE[name], batch,
                                          what)
        if name in SIZE_QLORA:
            out['qlora'] = qlora_size(model, n_params,
                                      f'{name} {SIZE_QUANTIZE[name]}')
    out['train'] = {}
    for key, budget, ckpt, reps, falls in TRAIN_CELLS:
        if key in trains:
            out['train'][key] = train_cell(
                model, plm_cls, key, budget, ckpt,
                SIZE_TRAIN_REPS.get((name, key), reps), falls, n_params,
                prof, what=f'{name} ')
    if trains:
        out['grad_checks'] = check_grads(model, plm_cls, f'{name} ')
    del model
    torch.cuda.empty_cache()
    return out


def quantized_size(model, mode, batch, what):
    """Phase 12 (f): ``quantize(mode)`` of a size's model on the card (one
    layer slice at a time), then phase 4's inference cell again on the same
    batch: launches exact, log-probs finite normalised rows, the median of
    the timed forwards, real tokens/s and peak memory."""
    L = model.config.num_layers
    dense_bytes = sum(p['kernel'].numel() * p['kernel'].element_size()
                      for sub in model.params['layers'].values()
                      for name, p in sub.items() if name in QUANT_LINEARS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.quantize(mode)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    qpeak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    q, other = quant_bytes(model.params)
    if dense_linears(model.params):
        fail(f'{what} {mode}: dense linears {dense_linears(model.params)}')
    out = {'mode': mode, 'quantize_s': secs, 'quantize_peak_mem_gib': qpeak,
           'dense_linear_bytes': dense_bytes, 'quantized_bytes': q,
           'other_bytes': other,
           'launches': inference_run(model, batch, f'{what} {mode}',
                                     expected_launches(**{H1_NAME: L,
                                                          H3_NAME: L}))}
    out.update(inference_times(model, batch, f'{what} {mode}'))
    log(f'{what} {mode}: quantize() {secs:.1f} s (peak {qpeak:.2f} GiB), '
        f'the linears {dense_bytes / 1e9:.2f} GB in bf16 -> '
        f'{q / 1e9:.2f} GB quantized (dense leaves {other / 1e9:.2f} GB); '
        f'50k forward {out["ms_per_batch"]:.2f} ms, '
        f'{out["real_tokens_per_s"]:.1f} real tokens/s, peak '
        f'{out["peak_mem_gib"]:.2f} GiB')
    return out


def check_sizes(dev, plm_cls, batch, runs=SIZE_RUNS, head_dims=SIZE_HEAD_DIMS,
                profile_dir=None):
    """Phase 12: each size of ``runs`` (``check_size``), then H1's and H2's
    times at ``head_dims`` (``time_head_dim``). Returns ``(sizes,
    {H1_NAME: {D: row}, H2_NAME: {D: row}})``."""
    sizes = {name: check_size(name, trains, dev, plm_cls, batch, profile_dir)
             for name, trains in runs}
    for name, s in sizes.items():
        cells = ', '.join(f'{key}@{c["budget"]} {c["ms_per_step"]:.2f} ms '
                          f'({c["real_tokens_per_s"]:.1f} real tokens/s, '
                          f'{c["peak_mem_gib"]:.2f} GiB)'
                          for key, c in s['train'].items())
        log(f'{name} (D = {s["head_dim"]}): inference '
            f'{s["ms_per_batch"]:.2f} ms ({s["real_tokens_per_s"]:.1f} real '
            f'tokens/s, {s["peak_mem_gib"]:.2f} GiB)'
            + (f'; train {cells}' if cells else ''))
    _, cu, _ = batch
    _, tcu, _ = packed_batch(BUDGET, seed=2)
    rows = {H1_NAME: {}, H2_NAME: {}}
    for d, h in head_dims:
        for kernel, row in time_head_dim(d, h, cu, tcu, dev).items():
            rows[kernel][str(d)] = row
    return sizes, rows


# Phase 13, the memory slice. The ESM2-650M cells of (d) and (f) are
# phase 5's nockpt@10k; (d) and (e) take ten timed steps (phase 12's count
# for 3B, whose fresh optimizer lifts the loss at step 3); (f) compares
# CP_COMPARE_STEPS steps with MaskedPLM's under CP_LOSS_REL.
MEMORY_FAMILIES = ('esmc_300m', 'esm1b')
ADAM8BIT_REPS = 10
OPTIMIZER_REPS = 3


def build_esm2(cfg, dev):
    from esme_tpu_torch import ESM2
    model = ESM2(**cfg, dtype='bfloat16', rng=0, device=dev)
    torch.cuda.synchronize()
    return model, sum(p.numel() for p in _leaves(model.params))


# Leaves whose gradient may give other bits from call to call on the card,
# held under the remat gates instead of bit for bit: none since the token
# embedding's backward became a fixed-order product
# (models/modules.py:embedding_grad); ``aten::embedding_dense_backward``
# was not reproducible at ESMC's vocabulary of 64.
NONDETERMINISTIC_LEAVES = ()
EMBEDDING_REPEATS = 4


def embedding_backward_repeats(dev, card):
    """How many of ``EMBEDDING_REPEATS`` gradients of the port's token
    embedding (``models/modules.py:embed_tokens`` through autograd) after a
    first give other bits than the first, on the same bf16 output gradient
    and ids (50,176 tokens, seed 0), at ESMC's vocabulary and width (64,
    960) and ESM2's (33, 1280): fails unless 0. The fixed-order gradient
    (``embedding_grad``) and ``aten::embedding_dense_backward`` (the
    backward it replaced, and its count of differing repeats) are timed
    alone, logged, not gated."""
    from esme_tpu_torch.models.config import esm2_config, esmc_config
    from esme_tpu_torch.models.modules import embed_tokens, embedding_grad
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for cfg in (esmc_config(), esm2_config()):
        vocab, width = cfg.vocab_size, cfg.embed_dim
        ids = torch.randint(0, vocab, (50_176,), device=dev, generator=gen)
        dy = torch.randn(50_176, width, device=dev, generator=gen) \
            .to(torch.bfloat16)
        table = torch.randn(vocab, width, device=dev, generator=gen) \
            .to(torch.bfloat16).requires_grad_()

        def port():
            x = embed_tokens(ids, {'embed_tokens': table}, cfg)
            return torch.autograd.grad(x, table, dy)[0]
        first, *rest = [port() for _ in range(EMBEDDING_REPEATS + 1)]
        aten = [torch.ops.aten.embedding_dense_backward(
            dy, ids, vocab, -1, False) for _ in range(EMBEDDING_REPEATS + 1)]
        key = f'vocab {vocab}, width {width}'
        out[key] = {
            'differing_repeats': sum(not torch.equal(first, r)
                                     for r in rest),
            'aten_differing_repeats': sum(not torch.equal(aten[0], r)
                                          for r in aten[1:]),
            'ms': cuda_ms(lambda: embedding_grad(ids, dy, vocab), reps=20),
            'aten_ms': cuda_ms(lambda: torch.ops.aten.embedding_dense_backward(
                dy, ids, vocab, -1, False), reps=20)}
    log(f'[{card}] the token embedding\'s gradient, repeated '
        f'{EMBEDDING_REPEATS} times after a first on the same inputs: '
        f'{out} (gate: the port\'s differing repeats 0)')
    bad = {k: v['differing_repeats'] for k, v in out.items()
           if v['differing_repeats']}
    if bad:
        fail(f'the token embedding\'s gradient is not reproducible: {bad}')
    return out


def grads_and_embedding_grad(plm, batch):
    """``plm._grad_step(batch)`` and the gradient of the loss with respect
    to the token embedding's output (a hook on ``embed_tokens``)."""
    from esme_tpu_torch.models import esm as mesm
    embed, box = mesm.embed_tokens, {}

    def hooked(tokens, params, cfg):
        x = embed(tokens, params, cfg)
        if x.requires_grad:
            x.register_hook(lambda g: box.__setitem__('dx', g.clone()))
        return x
    mesm.embed_tokens = hooked
    try:
        loss, grads = plm._grad_step(batch)
    finally:
        mesm.embed_tokens = embed
    return loss, grads, box['dx']


def remat_grads(plm_cls, model, batch, what):
    """The loss, every leaf's gradient and the gradient reaching the token
    embedding of one step under ``remat='full'`` and ``remat='attn'``
    (``plm_cls(model, remat)``, a step of ``_grad_step(batch)``): fails
    unless the loss, the embedding's incoming gradient and every leaf are
    bit-equal, but a leaf of ``NONDETERMINISTIC_LEAVES``, which may differ
    within the remat gates (``REMAT_MIN_COS``, ``REMAT_MAX_REL``)."""
    loss_f, grads_f, dx_f = grads_and_embedding_grad(plm_cls(model, 'full'),
                                                     batch)
    loss_a, grads_a, dx_a = grads_and_embedding_grad(plm_cls(model, 'attn'),
                                                     batch)
    pairs = list(_leaf_pairs(grads_a, grads_f))
    differ = [name for name, a, b in pairs if not torch.equal(a, b)]
    noisy = {name: a for name, a, _ in pairs
             if name in differ and name in NONDETERMINISTIC_LEAVES}
    check = compare_grads(noisy,
                          {name: b for name, _, b in pairs if name in noisy},
                          REMAT_MIN_COS, REMAT_MAX_REL,
                          f'{what}: the nondeterministic leaves') \
        if noisy else None
    dx_equal = bool(torch.equal(dx_a, dx_f))
    log(f"{what}: remat='attn' vs 'full', one step: loss {loss_a.item():.6f} "
        f'vs {loss_f.item():.6f}; the gradient reaching the embedding '
        f'bit-equal {dx_equal}; {len(pairs) - len(differ)} of {len(pairs)} '
        f'leaves bit-equal' + (f', {sorted(noisy)} within the remat gates '
                               f'({check})' if noisy else ''))
    if not torch.equal(loss_a, loss_f) or not dx_equal \
            or set(differ) - set(noisy):
        fail(f"{what}: remat='attn' is not bit-equal to 'full': loss "
             f'{loss_a.item()} vs {loss_f.item()}, the embedding\'s incoming '
             f'gradient equal {dx_equal}, leaves {differ}')
    del grads_f, grads_a
    torch.cuda.empty_cache()
    return {'loss': loss_a.item(), 'leaves': len(pairs),
            'bit_equal': len(pairs) - len(differ),
            'embedding_grad_bit_equal': dx_equal,
            'nondeterministic_leaves': check}


def check_remat_attn(card, name, model, n_params, grad_checks=False):
    """Phase 13 (a), (b): ``model`` in TRAIN_CELLS' ``ckpt@50k`` cell with
    ``remat='attn'`` beside ``remat='full'``: one step's loss and every
    leaf's gradient bit-equal, then each policy's cell (launches exact:
    H1 2·L with 'full' and L with 'attn', H2 L, H3 3·L of which L inverse
    where the family has RoPE), ms per step, real tokens/s, MFU and peak
    memory; with ``grad_checks``, phase 5's gradient checks at 4k."""
    import functools
    from esme_tpu_torch.train import MaskedPLM
    key, budget, ckpt, reps, falls = TRAIN_CELLS[1]
    L, rot = model.config.num_layers, int(model.config.rotary)
    what = f'[{card}] {name} {key}@{budget}'
    model.checkpointing = True
    batch, _ = train_batch(budget, model)
    out = {'grads': remat_grads(lambda m, r: MaskedPLM(m, remat=r), model,
                                batch, what)}
    model.checkpointing = False
    if grad_checks:
        out['grad_checks'] = check_grads(model, MaskedPLM, f'[{card}] {name} ')
    for remat in ('full', 'attn'):
        out[remat] = train_cell(
            model, functools.partial(MaskedPLM, remat=remat),
            f'{key}_{remat}', budget, ckpt, reps, falls, n_params, None,
            what=f'[{card}] {name} remat={remat!r} ',
            expected=expected_launches(**{
                H1_NAME: (2 if remat == 'full' else 1) * L, H2_NAME: L,
                H3_NAME: rot * 3 * L, 'rope_inverse': rot * L}))
    f, a = out['full'], out['attn']
    out['ms_ratio'] = a['ms_per_step'] / f['ms_per_step']
    out['peak_delta_gib'] = a['peak_mem_gib'] - f['peak_mem_gib']
    log(f"{what}: remat='attn' {a['ms_per_step']:.2f} ms per step "
        f"({a['real_tokens_per_s']:.1f} real tokens/s, MFU {a['mfu']:.4f}, "
        f"peak {a['peak_mem_gib']:.2f} GiB) against 'full' "
        f"{f['ms_per_step']:.2f} ms ({f['real_tokens_per_s']:.1f}, "
        f"{f['mfu']:.4f}, {f['peak_mem_gib']:.2f} GiB): "
        f"{out['ms_ratio']:.4f} of its time, "
        f"{out['peak_delta_gib']:+.2f} GiB")
    return out


def check_cp_remat_attn(dev, card, phase11):
    """Phase 13 (c): phase 11's one-rank ``ShardedMaskedPLM(seq_axis=
    'seq')`` ``ckpt@50k`` with ``remat='attn'``: one step's loss and every
    leaf's gradient bit-equal to ``remat='full'``'s, then its cell with
    launches exact (H9 L, H10 L, H3 3·L of which L inverse), beside phase
    11's cell. The process group is destroyed at the end."""
    import torch.distributed as dist
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    from esme_tpu_torch.train import ShardedMaskedPLM
    key, budget, ckpt, reps, _ = TRAIN_CELLS[1]
    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0,
                           device=dev.type)
    try:
        mesh = make_mesh(1, 1, seq=1, device=dev.type)
        model, n_params = build_esm2(MODEL, dev)
        L = model.config.num_layers
        model.checkpointing = True
        batch, _ = train_batch(budget, model)

        class sharded:
            def __init__(self, m, learning_rate=1e-4, remat='attn'):
                self.plm = ShardedMaskedPLM(m, mesh, seq_axis='seq',
                                            learning_rate=learning_rate,
                                            remat=remat)

            def training_step(self, batch):
                return self.plm.training_step([batch])

            def _grad_step(self, batch):
                return self.plm._grad_step([batch])
        what = f'[{card}] context-parallel {key}@{budget}'
        out = {'grads': remat_grads(lambda m, r: sharded(m, remat=r), model,
                                    batch, what)}
        cell = train_cell(
            model, sharded, f'cp_{key}_attn', budget, ckpt, CP_TRAIN_STEPS,
            True, n_params, None,
            what=f"[{card}] ShardedMaskedPLM(seq_axis=seq, remat='attn'): ",
            expected=expected_launches(**{
                H9_NAME: L, H10_NAME: L, H3_NAME: 3 * L, 'rope_inverse': L}))
        out['attn'] = cell
        out['phase11_ms_per_step'] = phase11['ms_per_step']
        out['phase11_peak_mem_gib'] = phase11['peak_mem_gib']
        log(f"{what}: remat='attn' {cell['ms_per_step']:.2f} ms per step, "
            f"peak {cell['peak_mem_gib']:.2f} GiB; 'full' (phase 11) "
            f"{phase11['ms_per_step']:.2f} ms, "
            f"{phase11['peak_mem_gib']:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def optimizer_ms(plm, batch):
    """The median host-clock ms of ``plm.optimizer.step()`` alone, on one
    batch's gradients, between synchronisations (``OPTIMIZER_REPS``)."""
    from esme_tpu_torch.ops.linear import fp32_accumulation
    with fp32_accumulation():
        plm._loss(plm._views, batch).backward()
    samples = []
    for _ in range(OPTIMIZER_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plm.optimizer.step()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    plm._zero_grads()
    return float(np.median(samples))


def check_first_update(model, batch, card):
    """Phase 13 (d)'s gate: the first ``adam8bit`` update on the card
    against the same arithmetic on the CPU from the same gradients and
    params. Every step of it is IEEE fp32 on both sides (the bias
    corrections from the host, the divisors device tensors, the square
    roots correctly rounded), so the codes, the scales and the updated
    params must be bit-equal. Also its state's bytes: exactly one code
    byte per param and moment, and two fp32 scales per leaf."""
    from esme_tpu_torch.train import MaskedPLM, adam8bit
    from esme_tpu_torch.train.trainer import (_leaves as tleaves, _map,
                                              _rows, leaf_groups,
                                              train_views)
    plm = MaskedPLM(model, optimizer=adam8bit(1e-4))
    _, grads = plm._grad_step(batch)
    cpu_params = _map(lambda t: t.detach().to('cpu', copy=True), model.params)
    cpu_views = train_views(cpu_params)
    cpu_opt = adam8bit(1e-4)([{'params': g} for g in leaf_groups(cpu_views)])
    cpu_rows = [t for t in tleaves(cpu_views) if t.requires_grad]
    for p, g in zip(cpu_rows, _rows(_map(lambda t: t.cpu(), grads))):
        p.grad = g
    for p, g in zip(plm._params, _rows(grads)):
        p.grad = g
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plm.optimizer.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_opt.step()
    t2 = time.perf_counter()
    out = {'groups': len(plm.optimizer.param_groups), 'tensors': 0,
           'codes_differ': 0, 'params_differ': 0, 'scales_differ': 0,
           'card_ms': (t1 - t0) * 1e3, 'cpu_ms': (t2 - t1) * 1e3}
    code_bytes = scale_bytes = 0
    for g, cg in zip(plm.optimizer.param_groups, cpu_opt.param_groups):
        head, chead = plm.optimizer.state[g['params'][0]], \
            cpu_opt.state[cg['params'][0]]
        for k in ('mu_scale', 'nu_scale'):
            out['scales_differ'] += not torch.equal(head[k].cpu(), chead[k])
            scale_bytes += head[k].numel() * head[k].element_size()
        for p, cp in zip(g['params'], cg['params']):
            out['tensors'] += 1
            out['params_differ'] += int((p.detach().cpu() != cp.detach())
                                        .sum())
            for k in ('mu', 'nu'):
                code = plm.optimizer.state[p][k]
                code_bytes += code.numel() * code.element_size()
                out['codes_differ'] += int(
                    (code.view(torch.uint8).cpu()
                     != cpu_opt.state[cp][k].view(torch.uint8)).sum())
    n_params = sum(p.numel() for p in _leaves(model.params))
    out.update(code_bytes=code_bytes, scale_bytes=scale_bytes,
               params=n_params)
    log(f'[{card}] adam8bit, the first update on the card against the CPU '
        f'from the same gradients: {out}')
    if out['codes_differ'] or out['params_differ'] or out['scales_differ']:
        fail(f'adam8bit: the card\'s first update is not the CPU\'s: {out}')
    if code_bytes != 2 * n_params or scale_bytes != 8 * out['groups']:
        fail(f'adam8bit: the state holds {code_bytes} code bytes and '
             f'{scale_bytes} scale bytes for {n_params} params in '
             f'{out["groups"]} leaves')
    del plm, cpu_opt, cpu_params, cpu_views, grads
    torch.cuda.empty_cache()
    return out


def check_adam8bit(dev, card, size, cfg, check_update, phase_peak=None):
    """Phase 13 (d), (e): ``size`` (an ESM2 config) in TRAIN_CELLS'
    ``nockpt@10k`` cell with ``optimizer=adam8bit(1e-4)``, fresh seed-0
    weights, ``ADAM8BIT_REPS`` timed steps under phase 5's gates; with
    ``check_update``, first the first update against the CPU and an Adam
    cell from the same weights beside it, and both optimizers' step
    timed alone. ``phase_peak``: an earlier Adam cell's peak, logged."""
    import functools
    from esme_tpu_torch.train import MaskedPLM, adam8bit
    key, budget, ckpt, _, falls = TRAIN_CELLS[0]
    out = {}
    plms = {'adam': MaskedPLM,
            'adam8bit': functools.partial(MaskedPLM,
                                          optimizer=adam8bit(1e-4))}
    for opt in ('adam', 'adam8bit') if check_update else ('adam8bit',):
        model, n_params = build_esm2(cfg, dev)
        batch, _ = train_batch(budget, model)
        if check_update and opt == 'adam8bit':
            out['first_update'] = check_first_update(model, batch, card)
            model, n_params = build_esm2(cfg, dev)
        if check_update:
            plm = plms[opt](model, learning_rate=1e-4)
            out[f'{opt}_optimizer_ms'] = optimizer_ms(plm, batch)
            del plm
            model, n_params = build_esm2(cfg, dev)
        out[opt] = train_cell(model, plms[opt], f'{key}_{opt}', budget, ckpt,
                              ADAM8BIT_REPS, falls, n_params, None,
                              what=f'[{card}] {size} {opt} ')
        del model
        torch.cuda.empty_cache()
    cell = out['adam8bit']
    line = (f"[{card}] {size} {key}@{budget} with adam8bit: "
            f"{cell['ms_per_step']:.2f} ms per step, peak "
            f"{cell['peak_mem_gib']:.2f} GiB")
    if check_update:
        out['peak_delta_gib'] = cell['peak_mem_gib'] \
            - out['adam']['peak_mem_gib']
        line += (f"; Adam {out['adam']['ms_per_step']:.2f} ms, "
                 f"{out['adam']['peak_mem_gib']:.2f} GiB "
                 f"({out['peak_delta_gib']:+.2f} GiB); optimizer step alone "
                 f"{out['adam8bit_optimizer_ms']:.2f} ms against Adam's "
                 f"{out['adam_optimizer_ms']:.2f} ms")
    if phase_peak is not None:
        out['adam_peak_mem_gib_phase12'] = phase_peak
        line += f'; Adam (phase 12) {phase_peak:.2f} GiB'
    log(line)
    return out


def rss_gib() -> float:
    """This process's resident host memory (``/proc/self/status``)."""
    with open('/proc/self/status') as f:
        for row in f:
            if row.startswith('VmRSS:'):
                return int(row.split()[1]) / 2**20
    return float('nan')


class MasterAdam:
    """The offload's arithmetic with everything on the card: ``MaskedPLM``'s
    forward and backward on the bf16 params, fp32 master copies and
    ``torch.optim.Adam(fused=True)`` over them on the card, the masters
    rounded into the params after each update. Phase 13 (f) holds the
    host-offloaded trainer to it."""

    def __init__(self, model, learning_rate):
        from esme_tpu_torch.train import MaskedPLM
        from esme_tpu_torch.train.trainer import (_leaves as tleaves, _map,
                                                  train_views)
        self.plm = MaskedPLM(model, learning_rate=learning_rate)
        self.masters = _map(lambda t: t.float(), model.params)
        views = [t for t in tleaves(train_views(self.masters))
                 if t.requires_grad]
        self.pairs = list(zip(self.plm._params, views))
        self.up = list(zip(_leaves(model.params), _leaves(self.masters)))
        self.opt = torch.optim.Adam(views, lr=learning_rate, fused=True)

    def training_step(self, batch):
        from esme_tpu_torch.ops.linear import fp32_accumulation
        with fp32_accumulation():
            loss = self.plm._loss(self.plm._views, batch)
            loss.backward()
        for p, m in self.pairs:
            m.grad = p.grad.float()
            p.grad = None
        self.opt.step()
        with torch.no_grad():
            for param, master in self.up:
                param.copy_(master)
        return float(loss.detach())


def check_offload(dev, card):
    """Phase 13 (f): ESM2-650M in TRAIN_CELLS' ``nockpt@10k`` cell with
    ``offload_optimizer=True``, against the same arithmetic on the card
    (:class:`MasterAdam`) and beside ``MaskedPLM`` on the card, each from
    fresh seed-0 weights for ``CP_COMPARE_STEPS`` steps. Gates: each loss
    within ``CP_LOSS_REL`` of :class:`MasterAdam`'s, the first equal to
    ``MaskedPLM``'s (the same weights and forward), launches exact in the
    first step (phase 5's). ``MaskedPLM``'s later losses are logged, not
    gated: its Adam updates the bf16 params themselves, and at lr 1e-4 an
    update under half an ulp of a weight is rounded away, where the fp32
    masters keep it. Logged: each step's parts timed alone on the host
    clock (the device's forward and backward, grads down, the host
    update, params up), the peak device memory of each trainer, the host
    memory the offload holds, the process's resident memory and the
    host's cores."""
    from esme_tpu_torch.train import MaskedPLM
    key, budget, _, _, _ = TRAIN_CELLS[0]
    L = MODEL['num_layers']
    runs = {}
    for name in ('masked_plm', 'master_adam', 'offload'):
        model, _ = build_esm2(MODEL, dev)
        batch, _ = train_batch(budget, model)
        rss0 = rss_gib()
        t0 = time.perf_counter()
        plm = MasterAdam(model, 1e-4) if name == 'master_adam' else \
            MaskedPLM(model, learning_rate=1e-4,
                      offload_optimizer=name == 'offload')
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        losses, ms, parts = [], [], []
        for i in range(CP_COMPARE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(plm.training_step(batch))
            ms.append((time.perf_counter() - t0) * 1e3)
            if name == 'offload':
                parts.append(dict(plm._host.ms))
            if i == 0:
                expect_launches(f'[{card}] {name} {key}', read_counters(),
                                **{H1_NAME: L, H2_NAME: L, H3_NAME: 2 * L,
                                   'rope_inverse': L})
        run = {'losses': losses, 'ms_per_step_samples': ms,
               'ms_per_step': float(np.median(ms)), 'setup_s': setup_s,
               'peak_mem_gib': torch.cuda.max_memory_allocated() / 2**30}
        if name == 'offload':
            run.update(parts=parts, host_gib=plm._host.host_bytes() / 2**30,
                       rss_delta_gib=rss_gib() - rss0,
                       cpu_count=os.cpu_count(),
                       parts_median_ms={k: float(np.median([p[k]
                                                            for p in parts]))
                                        for k in parts[0]})
        runs[name] = run
        del plm, model
        torch.cuda.empty_cache()
    off, ref, bf = runs['offload'], runs['master_adam'], runs['masked_plm']

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a['losses'],
                                                    b['losses'])]
    runs.update(loss_rel=rel(off, ref), loss_rel_masked_plm=rel(off, bf),
                peak_delta_gib=off['peak_mem_gib'] - bf['peak_mem_gib'])
    log(f'[{card}] ESM2-650M {key}@{budget}, offload_optimizer=True: losses '
        f"{off['losses']} vs the same arithmetic on the card "
        f"{ref['losses']} (relative {[f'{x:.2e}' for x in runs['loss_rel']]}"
        f", gate {CP_LOSS_REL}) and MaskedPLM's {bf['losses']} (relative "
        f"{[f'{x:.2e}' for x in runs['loss_rel_masked_plm']]}, the first "
        f"equal); {off['ms_per_step']:.1f} ms per step (parts, medians "
        f"{off['parts_median_ms']}) against MaskedPLM's "
        f"{bf['ms_per_step']:.1f}; peak device memory "
        f"{off['peak_mem_gib']:.2f} GiB against {bf['peak_mem_gib']:.2f} "
        f"({runs['peak_delta_gib']:+.2f}); host memory held "
        f"{off['host_gib']:.2f} GiB, resident {off['rss_delta_gib']:+.2f} "
        f"GiB, {off['cpu_count']} cores, setup {off['setup_s']:.1f} s")
    if not all(np.isfinite(off['losses'])) \
            or max(runs['loss_rel']) > CP_LOSS_REL \
            or off['losses'][0] != bf['losses'][0]:
        fail(f'offload_optimizer: losses {off["losses"]} against the same '
             f'arithmetic on the card {ref["losses"]} (gate {CP_LOSS_REL}) '
             f'and MaskedPLM\'s {bf["losses"]} (the first equal)')
    return runs


def check_memory(dev, card, phase11, sizes):
    """Phase 13, the memory slice: (a) ESM2-650M ``ckpt@50k`` with
    ``remat='attn'`` beside ``'full'``; (b) ESMC-300M's and ESM1b's
    ``ckpt@50k`` cells, both policies; (c) phase 11's one-rank CP cell with
    ``remat='attn'``; (d) ESM2-650M ``nockpt@10k`` with ``adam8bit``; (e)
    ESM2-3B ``nockpt@10k`` with ``adam8bit``; (f) ESM2-650M ``nockpt@10k``
    with ``offload_optimizer=True``. Each part's seconds are logged."""
    import esme_tpu_torch
    from esme_tpu_torch.models.config import ESM2_SIZES
    out, seconds = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        log(f'[{card}] phase 13 {key}: {seconds[key]:.1f} s')

    timed('embedding_backward_repeats',
          lambda: embedding_backward_repeats(dev, card))
    timed('a_esm2_650m', lambda: check_remat_attn(
        card, 'esm2_650m', *build_esm2(MODEL, dev)))
    for seed, (name, cls_name, kwargs, _) in enumerate(FAMILY_RUNS):
        if name not in MEMORY_FAMILIES:
            continue

        def family(seed=seed, name=name, cls_name=cls_name, kwargs=kwargs):
            model = getattr(esme_tpu_torch, cls_name)(**kwargs, rng=seed,
                                                      device=dev)
            n = sum(p.numel() for p in _leaves(model.params))
            return check_remat_attn(card, name, model, n,
                                    grad_checks=True)
        timed(f'b_{name}', family)
    timed('c_context_parallel', lambda: check_cp_remat_attn(dev, card,
                                                            phase11))
    timed('d_esm2_650m_adam8bit', lambda: check_adam8bit(
        dev, card, 'esm2_650m', MODEL, True))
    three_b = sizes.get('esm2_3b', {}).get('train', {}).get('nockpt', {})
    timed('e_esm2_3b_adam8bit', lambda: check_adam8bit(
        dev, card, 'esm2_3b', ESM2_SIZES['esm2_3b'], False,
        three_b.get('peak_mem_gib')))
    timed('f_offload', lambda: check_offload(dev, card))
    out['seconds'] = seconds
    return out


# -------------------------------------------------------------------------
# Phase 14: the fine-tune slice. ESM2-650M at phase 4's size and seed-0
# weights with LoRA rank 16 on query, value and output and the
# learned-aggregation head of 4 heads (benchmarks/tasks.py's defaults), at
# the budget and truncation of the task script (benchmarks/tasks.py:
# 134-140). The step is held and timed on full batches at the lengths of
# the tasks (FT_LENGTHS); the task loop runs on the script's smoke-mode
# splits (synthetic GB1-like regression, TF-like binary).
# -------------------------------------------------------------------------

FT_BUDGET = 10_000
FT_TRUNCATE = 1000
FT_RANK = 16
FT_HEAD_HEADS = 4
FT_LR, FT_HEAD_LR = 1e-4, 1e-3
# sequences per train split (val and test a quarter): ~20k tokens of 20-59
# residues, so an epoch is two full 10k batches and a remainder
FT_SPLIT_N = 480
FT_EPOCHS = 2
FT_REPS = 5             # timed fine-tune steps after a warm-up
# b of every adapter drawn from FT_B_STD·N(0, 1): with b = 0 the gradient
# of a is exactly 0 and holds nothing against the plain versions
FT_B_STD = 0.01
# kernels vs plain versions: the loss within the bf16 resolution (the
# kernels round p and o to bf16 at other points, phase 3's gates), every
# trainable leaf's gradient under phase 5's gates
FT_LOSS_REL = 2.0 ** -8
# the most of the head's ReLU units whose input may change sign between the
# kernels' run and the plain versions' (flipped_units; the gradients are
# held against a plain run with the kernels' pattern, pinned_head_relu)
FT_MAX_FLIPPED = 1 / 8
FT_TASKS = (('gb1', False), ('tf', True))
# the step's batches, (shortest, longest) residues of seeded random
# sequences: FLIP's GB1 sets hold one 265-residue construct; sequences past
# the task script's truncation (Meltome's long proteins) cut to 1,000; the
# smoke-mode splits' 20-59 for comparison with the task loop's batches
FT_LENGTHS = {'gb1_265': (265, 265), 'trunc_1000': (1000, 1400),
              'smoke': (20, 59)}
FT_GRAD_CELLS = ('gb1_265', 'trunc_1000')


def synthetic_splits(task, n=48, seed=None):
    """``benchmarks/tasks.py:106-124``'s smoke-mode data, copied: per-task
    seeds, ``n`` train sequences of 20-59 residues (val and test ``n //
    4``), labels ``len / 60`` (regression) or ``len > 40`` (tf)."""
    if seed is None:
        seed = {'meltome': 11, 'gb1': 22, 'aav': 33, 'tf': 44}[task]
    rng = np.random.default_rng(seed)
    aas = list('LAGVSERTIDPKQNFYMHWC')
    splits = {}
    for name, k in [('train', n), ('val', n // 4), ('test', n // 4)]:
        seqs = [''.join(rng.choice(aas, rng.integers(20, 60)))
                for _ in range(k)]
        if task == 'tf':
            labels = [float(len(s) > 40) for s in seqs]
        else:
            labels = [len(s) / 60.0 for s in seqs]
        splits[name] = (seqs, labels)
    return splits


def ft_dataset(splits, split, model, binary, epoch=0, shuffle=False):
    """The task script's ``dataset`` (``benchmarks/tasks.py:197-205``):
    the train split of a binary task upsampled to balance."""
    from esme_tpu_torch import LabeledDataset, balance_binary
    seqs, labels = splits[split]
    if binary and split == 'train':
        seqs, labels = balance_binary(seqs, labels, 'upsample')
    return LabeledDataset(seqs, labels, token_per_batch=FT_BUDGET,
                          shuffle=shuffle, random_state=epoch,
                          truncate_len=FT_TRUNCATE, alphabet=model.alphabet)


def length_batch(model, lengths, seed=7):
    """The first batch of ``LabeledDataset`` at the task's budget and
    truncation over seeded random sequences of ``lengths`` residues (both
    ends included) with N(0, 1) regression labels: a full batch."""
    lo, hi = lengths
    rng = np.random.default_rng(seed)
    n = 2 * FT_BUDGET // (min(lo, FT_TRUNCATE) + 2)
    aas = list('LAGVSERTIDPKQNFYMHWC')
    seqs = [''.join(rng.choice(aas, rng.integers(lo, hi + 1)))
            for _ in range(n)]
    labels = rng.standard_normal(n).tolist()
    return ft_dataset({'train': (seqs, labels)}, 'train', model, False)[0]


def ft_model(dev, lift_b=False, model=None):
    """ESM2 at ``MODEL`` from seed 0 (or ``model``) with the task's
    adapters; with ``lift_b`` every ``b`` drawn from ``FT_B_STD``·N(0, 1)
    (seed 1)."""
    from esme_tpu_torch import ESM2
    if model is None:
        model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
    model.add_lora(rank=FT_RANK, alpha=FT_RANK,
                   layers=('query', 'value', 'output'), adapter_names=['ft'])
    if lift_b:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        for p in model.params['layers']['attn'].values():
            for ad in p.get('lora', {}).values():
                ad['b'].copy_(torch.randn(ad['b'].shape, generator=gen,
                                          device=dev) * FT_B_STD)
    return model


def ft_head(dev, seed=0):
    from esme_tpu_torch.models.heads import init_learned_aggregation
    return init_learned_aggregation(seed, MODEL['embed_dim'], num_cls=1,
                                    attention_heads=FT_HEAD_HEADS,
                                    dtype=torch.bfloat16, device=dev)


def ft_grads(trainer):
    """The gradients a trainer's ``_grad_step`` left: the trunk's in the
    layout of ``model.params`` (None for a frozen leaf), the head's."""
    from esme_tpu_torch.train.trainer import _grad_tree, _map
    return {'plm': _grad_tree(trainer._views),
            'head': _map(lambda t: t.grad.detach().clone(),
                         trainer._head_views)}


def _trained_only(tree):
    """``tree`` without its None leaves (frozen), and how many it had."""
    out, frozen = {}, 0
    for k, v in tree.items():
        if isinstance(v, dict):
            sub, n = _trained_only(v)
            frozen += n
            if sub:
                out[k] = sub
        elif v is None:
            frozen += 1
        else:
            out[k] = v
    return out, frozen


@contextlib.contextmanager
def head_preactivations(store):
    """Append the aggregation head's ReLU inputs ``(S, C, units)`` of each
    fine-tune trainer call to ``store``."""
    from esme_tpu_torch.models import heads
    from esme_tpu_torch.train import trainer
    apply = trainer.apply_learned_aggregation

    def recorded(params, x, seg_ids, num_segments, attention_heads):
        with torch.no_grad():
            pooled = heads.apply_learned_attention_pool(
                params, x, seg_ids, num_segments, attention_heads)
            store.append(heads.linear(pooled, params['linear']).float())
        return apply(params, x, seg_ids, num_segments, attention_heads)

    trainer.apply_learned_aggregation = recorded
    try:
        yield
    finally:
        trainer.apply_learned_aggregation = apply


@contextlib.contextmanager
def pinned_head_relu(masks):
    """The aggregation head with each call's ReLU replaced by a 0/1 mask
    of ``masks`` (in call order): given the kernels' run's pattern, the
    plain versions' run differentiates the same linear piece of the head,
    so the gradients differ by the kernels' rounding alone."""
    from esme_tpu_torch.models import heads
    from esme_tpu_torch.train import trainer
    apply = trainer.apply_learned_aggregation
    it = iter(masks)

    def pinned(params, x, seg_ids, num_segments, attention_heads):
        pooled = heads.apply_learned_attention_pool(
            params, x, seg_ids, num_segments, attention_heads)
        h = heads.linear(pooled, params['linear'])
        out = heads.linear(h * next(it).to(h.dtype), params['final'])[..., 0]
        return out[..., 0] if out.shape[-1] == 1 else out

    trainer.apply_learned_aggregation = pinned
    try:
        yield
    finally:
        trainer.apply_learned_aggregation = apply


def flipped_units(pre, what):
    """The head's ReLU units whose input changed sign between the kernels'
    run and the plain versions' for some segment (bf16 representations
    an ulp apart move a unit near 0 across it), counted. Fails if more
    than ``FT_MAX_FLIPPED`` of the units flipped."""
    flips = (pre[0] > 0) != (pre[1] > 0)
    flipped = flips.flatten(0, -2).any(0)
    n = int(flipped.sum())
    info = {'units': n, 'of_units': flipped.numel(),
            'segment_unit_pairs': int(flips.sum()),
            'of_pairs': flips.numel(),
            'max_abs_preactivation': pre[1][flips].abs().max().item()
            if n else 0.0}
    if n > FT_MAX_FLIPPED * flipped.numel():
        fail(f'fine-tune step {what}: {n} of the head\'s {flipped.numel()} '
             f'units changed sign between the kernels\' run and the plain '
             f'versions\' (gate {FT_MAX_FLIPPED} of them)')
    return info


def check_finetune_grads(model, head, batch, card, what, label=None):
    """(a) and (b): one ``RegressionTrainer`` step's loss and gradients
    with the kernels (launches counted from 0: H1 L, H2 L, H3 2L of which
    L inverse) and through the plain versions, from the same params, on
    the batch ``what`` names (``label`` in the logs, ``what`` if None).
    The loss is held against the plain versions' own run. The gradients,
    every entry, are held against a second plain run with the head's ReLU
    pattern of the kernels' run (:func:`pinned_head_relu`): a unit that
    :func:`flipped_units` finds (at most ``FT_MAX_FLIPPED`` of them) moves
    its own gradient entries and the gradient it sends the trunk's
    adapters by its whole contribution, which no rounding of the kernels
    explains. No quantized leaf may have a gradient."""
    from esme_tpu_torch.quant import NON_TRAINABLE_QUANT_LEAVES
    from esme_tpu_torch.train import RegressionTrainer
    L = model.config.num_layers
    what = label or what
    tt = RegressionTrainer(model, head, head_lr=FT_HEAD_LR, lr=FT_LR,
                           head_attention_heads=FT_HEAD_HEADS)
    pre = []
    with head_preactivations(pre):
        reset_counters()
        loss = tt._grad_step(batch)
        torch.cuda.synchronize()
        launches = read_counters()
        got = ft_grads(tt)
        with plain_versions():
            loss_p = tt._grad_step(batch)
    flips = flipped_units(pre, what)
    with pinned_head_relu([pre[0] > 0]), plain_versions():
        loss_pin = tt._grad_step(batch)
    ref = ft_grads(tt)
    quant_grads = [name for name, g in _named_leaves(got['plm'])
                   if name.split('.')[-1] in NON_TRAINABLE_QUANT_LEAVES
                   and name.split('.')[-2] in QUANT_LINEARS
                   and g is not None]
    if quant_grads:
        fail(f'fine-tune step {what}: quantized leaves with a gradient: '
             f'{quant_grads}')
    expected = expected_launches(**{H1_NAME: L, H2_NAME: L, H3_NAME: 2 * L,
                                    'rope_inverse': L})
    log(f'[{card}] fine-tune step {what}: launches {launches} (expected '
        f'{expected}); loss with kernels {loss.item():.6f}, plain versions '
        f'{loss_p.item():.6f} ({loss_pin.item():.6f} with the kernels\' '
        f'ReLU pattern)')
    if launches != expected:
        fail(f'fine-tune step {what}: a kernel launched {launches}, not '
             f'{expected}')
    rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    if not rel <= FT_LOSS_REL:
        fail(f'fine-tune step {what}: the loss with the kernels is '
             f'{rel:.3e} off the plain versions\' (gate {FT_LOSS_REL})')
    got, frozen = _trained_only(got)
    ref, frozen_p = _trained_only(ref)
    n_lora = sum(1 for t in model.params['layers']['attn'].values()
                 for _ in t.get('lora', {}).values()) * 2
    trained = sum(1 for _ in _leaves(got['plm']))
    if trained != n_lora or frozen != frozen_p or not frozen:
        fail(f'fine-tune step {what}: {trained} trunk leaves with a '
             f'gradient (expected {n_lora}: the adapters), frozen {frozen} '
             f'/ {frozen_p}')
    log(f'[{card}] fine-tune step {what}: {flips["units"]} of the head\'s '
        f'{flips["of_units"]} units changed sign ({flips["segment_unit_pairs"]}'
        f' of {flips["of_pairs"]} segment-unit pairs, |input| at most '
        f'{flips["max_abs_preactivation"]:.3g})')
    checks = compare_grads(got, ref, GRAD_MIN_COS, GRAD_MAX_REL,
                           f'[{card}] fine-tune gradients {what}, kernels '
                           'vs plain versions with the kernels\' ReLU '
                           'pattern', {'head.k.bias': 'head.k.kernel'})
    del tt, got, ref
    torch.cuda.empty_cache()
    return {'launches': launches, 'loss': loss.item(),
            'real_tokens': int(batch.cu_lens[-1]),
            'sequences': int((np.diff(batch.cu_lens) > 0).sum()),
            'loss_plain': loss_p.item(), 'loss_rel': rel,
            'loss_plain_pinned': loss_pin.item(),
            'frozen_leaves_without_grad': frozen, 'grads_vs_plain': checks,
            'flipped_head_units': flips}


def time_finetune(model, head, batch, card, phase5, what,
                  profile_dir=None, label=None):
    """(d) on the batch ``what`` names (``label`` in the logs): a warm-up
    ``RegressionTrainer.training_step`` with the counters set to 0 just
    before it (the launches of (b)), ``FT_REPS`` timed steps on the same
    full batch, one ``predict``'s launches (H1 L, H3 L), the optimizer's
    state bytes and the peak, beside phase 5's full MLM step at
    ``nockpt@10k``. The trained leaves are put back afterwards, so every
    batch's steps start from the same params."""
    from esme_tpu_torch.train import RegressionTrainer
    L = model.config.num_layers
    real = int(batch.cu_lens[-1])
    lengths, what = FT_LENGTHS[what], label or what
    tt = RegressionTrainer(model, head, head_lr=FT_HEAD_LR, lr=FT_LR,
                           head_attention_heads=FT_HEAD_HEADS)
    start = [p.detach().clone() for p in tt._params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses = [tt.training_step(batch)]
    launches = read_counters()
    expected = expected_launches(**{H1_NAME: L, H2_NAME: L, H3_NAME: 2 * L,
                                    'rope_inverse': L})
    if launches != expected:
        fail(f'fine-tune training_step {what}: launches {launches}, not '
             f'{expected}')
    samples = []
    for _ in range(FT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tt.training_step(batch))        # float(): a sync
        samples.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(samples))
    state_bytes = sum(t.numel() * t.element_size()
                      for st in tt.optimizer.state.values()
                      for t in st.values() if torch.is_tensor(t))
    trained = sum(p.numel() for p in tt._params)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = tt.predict(batch)
    predict_ms = (time.perf_counter() - t0) * 1e3
    predict_launches = read_counters()
    if predict_launches != expected_launches(**{H1_NAME: L, H3_NAME: L}):
        fail(f'fine-tune predict {what}: launches {predict_launches}')
    if not (np.isfinite(losses).all() and np.isfinite(pred).all()):
        fail(f'fine-tune steps {what}: losses {losses}, predictions finite '
             f'{np.isfinite(pred).all()}')
    cell = {'budget': FT_BUDGET, 'lengths': lengths,
            'truncate_len': FT_TRUNCATE, 'real_tokens': real,
            'sequences': int((np.diff(batch.cu_lens) > 0).sum()),
            'launches': launches, 'predict_launches': predict_launches,
            'losses': losses, 'ms_per_step': ms,
            'ms_per_step_samples': samples,
            'real_tokens_per_s': real / ms * 1e3,
            'trained_params': trained, 'optimizer_state_bytes': state_bytes,
            'peak_mem_gib': peak / 2**30, 'predict_ms': predict_ms,
            'mlm_nockpt_10k_ms_per_step': phase5['ms_per_step'],
            'mlm_nockpt_10k_real_tokens_per_s': phase5['real_tokens_per_s'],
            'mlm_nockpt_10k_peak_mem_gib': phase5['peak_mem_gib']}
    log(f'[{card}] fine-tune step {what} (LoRA r{FT_RANK} q/v/out + '
        f'aggregation head) at {FT_BUDGET}: {cell["sequences"]} sequences '
        f'of {lengths} residues, {real} real tokens; median {ms:.2f} ms of {FT_REPS} (samples '
        f'{[round(x, 2) for x in samples]}), {cell["real_tokens_per_s"]:.1f} '
        f'real tokens/s, {trained:,} trained params, optimizer state '
        f'{state_bytes:,} B, peak {cell["peak_mem_gib"]:.2f} GiB; losses '
        f'{[round(x, 5) for x in losses]}; predict {predict_ms:.2f} ms. '
        f'Full MLM step nockpt@10k (phase 5): {phase5["ms_per_step"]:.2f} ms,'
        f' {phase5["real_tokens_per_s"]:.1f} real tokens/s, '
        f'{phase5["peak_mem_gib"]:.2f} GiB')
    if profile_dir:
        _profile(lambda: tt.training_step(batch), profile_dir,
                 f'profile_finetune_{what}.txt', f'fine-tune step {what}')
    with torch.no_grad():
        for p, t in zip(tt._params, start):
            p.copy_(t)
    del tt, start
    torch.cuda.empty_cache()
    return cell


def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def finetune_task(dev, card, task, binary, tmp):
    """(c) one task as ``benchmarks/tasks.py:main`` runs it: epochs of
    ``training_step``, ``validation_metrics``, a ``MetricLogger`` line and
    ``CheckpointManager.save``; then the latest checkpoint restored into a
    fresh trainer (params, step and predictions bit-equal), and the
    adapters through ``save_lora`` into a fresh model (predictions with the
    trained head bit-equal)."""
    from esme_tpu_torch import ESM2, MetricLogger, read_log
    from esme_tpu_torch.train import (CheckpointManager,
                                      ClassificationTrainer,
                                      RegressionTrainer)
    cls = ClassificationTrainer if binary else RegressionTrainer
    monitor = 'val_auroc' if binary else 'val_spearman'
    splits = synthetic_splits(task, n=FT_SPLIT_N)
    model = ft_model(dev)
    tt = cls(model, ft_head(dev), head_lr=FT_HEAD_LR, lr=FT_LR,
             head_attention_heads=FT_HEAD_HEADS)
    out_dir = os.path.join(tmp, task)
    mgr = CheckpointManager(os.path.join(out_dir, 'ckpts'),
                            max_to_keep=FT_EPOCHS, monitor=monitor,
                            mode='max')
    val = ft_dataset(splits, 'val', model, binary)
    seconds = {}
    t_task = time.perf_counter()
    with MetricLogger(os.path.join(out_dir, 'metrics.jsonl'),
                      run=task) as logger:
        for epoch in range(FT_EPOCHS):
            train = ft_dataset(splits, 'train', model, binary, epoch, True)
            t0 = time.perf_counter()
            losses = [tt.training_step(b) for b in train]
            seconds[f'train_{epoch}'] = time.perf_counter() - t0
            t0 = time.perf_counter()
            metrics = tt.validation_metrics(val)
            seconds[f'validate_{epoch}'] = time.perf_counter() - t0
            rec = {'epoch': epoch, 'train_loss': float(np.mean(losses)),
                   **metrics}
            logger.log(rec, step=tt.step)
            logger.track_best(metrics)
            t0 = time.perf_counter()
            mgr.save(epoch, tt.state, metrics)
            seconds[f'save_{epoch}'] = time.perf_counter() - t0
    records = read_log(os.path.join(out_dir, 'metrics.jsonl'))
    if len(records) != FT_EPOCHS or not all(
            np.isfinite(r[k]) for r in records for k in r
            if k.startswith(('train_', 'val_'))):
        fail(f'fine-tune {task}: logged {records}')
    best = mgr.best_step()
    want = max(range(FT_EPOCHS), key=lambda e: (records[e][monitor], e))
    if mgr.all_steps() != list(range(FT_EPOCHS)) or best != want:
        fail(f'fine-tune {task}: checkpoints {mgr.all_steps()}, best {best} '
             f'(by the log {want})')
    vb = val[0]
    pred = tt.predict(vb)

    t0 = time.perf_counter()
    fresh = cls(ft_model(dev), ft_head(dev, seed=5), head_lr=FT_HEAD_LR,
                lr=FT_LR, head_attention_heads=FT_HEAD_HEADS)
    fresh.state = mgr.restore(fresh.state)
    seconds['restore'] = time.perf_counter() - t0
    if not (fresh.step == tt.step
            and _state_equal(fresh.state.params, tt.state.params)
            and np.array_equal(fresh.predict(vb), pred)):
        fail(f'fine-tune {task}: the restored trainer differs from the one '
             'it was saved from')
    del fresh
    lora_path = os.path.join(out_dir, 'lora.safetensors')
    model.save_lora(lora_path)
    reloaded = ESM2(**MODEL, dtype='bfloat16', rng=0,
                    device=dev).load_lora(lora_path)
    if reloaded.lora_kwargs != model.lora_kwargs or not np.array_equal(
            cls(reloaded, tt.head_params,
                head_attention_heads=FT_HEAD_HEADS).predict(vb), pred):
        fail(f'fine-tune {task}: predictions through save_lora/load_lora '
             'differ')
    out = {'records': records, 'best_step': best,
           'checkpoint_bytes': sum(
               os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(os.path.join(out_dir, 'ckpts'))
               for f in fs),
           'lora_file_bytes': os.path.getsize(lora_path),
           'train_batches': len(ft_dataset(splits, 'train', model, binary)),
           'steps': tt.step, 'seconds': seconds,
           'wall_s': time.perf_counter() - t_task}
    log(f'[{card}] fine-tune task {task} ({cls.__name__}, {FT_EPOCHS} '
        f'epochs of {out["train_batches"]} batches): '
        + '; '.join(f'epoch {int(r["epoch"])} train_loss '
                    f'{r["train_loss"]:.5f} ' + ' '.join(
                        f'{k} {v:.4f}' for k, v in r.items()
                        if k.startswith('val_')) for r in records)
        + f'; best {best}; checkpoint and save_lora round trips bit-equal; '
        f'seconds {({k: round(v, 2) for k, v in seconds.items()})}')
    del tt, model, reloaded
    torch.cuda.empty_cache()
    return out


def check_finetune(dev, card, phase5, profile_dir=None):
    """Phase 14, the fine-tune slice at ESM2-650M's full width: (a) and (b)
    :func:`check_finetune_grads` on the full batches of GB1's length and
    of the truncation's, (d) :func:`time_finetune` on those and on a
    smoke-mode batch, (c) :func:`finetune_task` for GB1 (regression) and
    TF (binary, upsampled) on the smoke-mode splits. Each part's seconds
    are logged."""
    out, seconds = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        log(f'[{card}] phase 14 {key}: {seconds[key]:.1f} s')

    model = ft_model(dev, lift_b=True)
    head = ft_head(dev)
    batches = {what: length_batch(model, lengths)
               for what, lengths in FT_LENGTHS.items()}
    for what in FT_GRAD_CELLS:
        timed(f'a_grads_{what}', lambda what=what: check_finetune_grads(
            model, head, batches[what], card, what))
    for what, batch in batches.items():
        timed(f'd_{what}', lambda what=what, batch=batch: time_finetune(
            model, head, batch, card, phase5, what, profile_dir))
    out['d_times'] = {what: out.pop(f'd_{what}') for what in batches}
    del model, head, batches
    torch.cuda.empty_cache()
    for task, binary in FT_TASKS:
        # one directory a task: its checkpoints hold the whole trunk
        with tempfile.TemporaryDirectory() as tmp:
            timed(f'c_{task}', lambda task=task, binary=binary, tmp=tmp:
                  finetune_task(dev, card, task, binary, tmp))
    out['seconds'] = seconds
    return out


# -------------------------------------------------------------------------
# Phase 15: variant scoring, the host data plane, position extension and
# the CLI. ESM2-650M from seed-0 weights written through the safetensors
# schema at full width and depth (the CLI loads the same file).
SCORE_LEN = 265             # FLIP GB1's length: 5,300 variants
SCORE_BATCH = 32            # 9 forwards of (32, 267)
LONG_LEN, LONG_MAX_LEN = 1500, 1024     # windows of ESM2's context
# the long sequence's batches held against the plain versions: the
# windows clamped at the start, centred, clamped at the end
LONG_CHECK_STARTS = (0, 734, 1468)
# (b) cut to a peptide: 16 positions x 20 residues x 16 masks = 5,120
# items, 40 forwards of (128, 18)
PPPL_LEN, PPPL_BATCH = 16, 128
# Gates of (a) and (b) against the same call through the plain versions:
# a mask-margin score is the difference of two log-probs, each under
# phase 4's MODEL_MAX_ABS; a pseudo-perplexity margin is a mean of
# log-probs, so under MODEL_MAX_ABS; the variants' ranking must survive
# the kernels' bf16 rounding as phase 4's per-token rows do
# (MODEL_MIN_COS).
SCORE_MAX_ABS = 2 * MODEL_MAX_ABS
PPPL_MAX_ABS = MODEL_MAX_ABS
SCORE_MIN_SPEARMAN = MODEL_MIN_COS
# (c) a seeded FASTA of 100-1000 residues, 60 a line, at least this big;
# batches at the 10k budget; DATA_STEPS timed steps a feed after a
# warm-up step; Prefetcher timed with these worker counts
DATA_FASTA_BYTES = 10 * 2 ** 20
DATA_BUDGET = 10_000
DATA_STEPS = 10
PROFILED_STEPS = 3          # a feed's steps under torch.profiler
DATA_WORKERS = (1, 4)
DATA_MODELS = (('esm2_650m', MODEL), ('esm2_8m', dict(
    num_layers=6, embed_dim=320, attention_heads=20)))
# (e) the published ESM1b's table (1,024 positions, 1,026 rows) grown to
# the reference's 4,096; the lengths run before and after
ESM1B_POSITIONS, EXTEND_TO = 1024, 4096
EXTEND_SHORT, EXTEND_LONG = 500, 3000
EXTEND_TRAIN_LENS = (4000, 3000, 2990)      # 9,996 of a 10k batch
AMINO = 'LAGVSERTIDPKQNFYMHWC'


def seeded_seq(n, seed):
    rng = np.random.default_rng(seed)
    return ''.join(np.asarray(list(AMINO))[rng.integers(0, 20, n)])


def _score_arrays(got: dict, ref: dict):
    if list(got) != list(ref):
        fail('the scores of the kernels and of the plain versions have '
             'other variants')
    return (np.array(list(got.values())), np.array(list(ref.values())))


def compare_scores(got, ref, max_abs, what, card):
    """max|Δscore| and Spearman ρ of ``got`` (kernels) against ``ref``
    (plain versions) over every variant; fails outside the gates."""
    from esme_tpu_torch.metrics import spearman
    a, b = _score_arrays(got, ref)
    err, rho = float(np.abs(a - b).max()), spearman(a, b)
    ok = err <= max_abs and rho >= SCORE_MIN_SPEARMAN and \
        bool(np.isfinite(a).all())
    log(f'[{card}] {what}: {len(a)} variants, kernels vs plain versions '
        f'max|Δscore| {err:.4f} (gate {max_abs}), mean {np.abs(a - b).mean():.5f}'
        f', Spearman ρ {rho:.6f} (gate {SCORE_MIN_SPEARMAN}); scores in '
        f'[{a.min():.3f}, {a.max():.3f}] {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{what}: scores out of gate')
    return {'variants': len(a), 'max_abs_err': err, 'spearman': rho}


def timed_scoring(fn, forwards, L, what, card):
    """``fn()`` (a scoring call) with the launch counters set to 0 just
    before and read just after (H1 and H3 ``L`` per forward, nothing
    else), timed on the host clock (the call ends on the host: its scores
    are host floats), with its peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    expect_launches(f'{what} ({forwards} forwards)', launches,
                    **{H1_NAME: L * forwards, H3_NAME: L * forwards})
    return out, ms, launches, torch.cuda.max_memory_allocated() / 2 ** 30


def check_scoring(model, card):
    """(a) ``predict_mask_margin`` on a seeded 265-residue sequence (a
    first call counts the launches, a second is timed), against the plain
    versions over all 5,300 variants; ``predict_pseudoperplexity`` on it;
    the seeded 1,500-residue sequence at ``max_len`` 1,024, its
    ``LONG_CHECK_STARTS`` batches against the plain versions; (b)
    ``predict_pseudoperplexity_margin`` on a seeded 16-residue peptide,
    against the plain versions."""
    from esme_tpu_torch.variant import (MaskMarginDataset,
                                        predict_mask_margin,
                                        predict_pseudoperplexity,
                                        predict_pseudoperplexity_margin)
    L = model.config.num_layers
    seq = seeded_seq(SCORE_LEN, 11)
    fwd = math.ceil(SCORE_LEN / SCORE_BATCH)
    run = lambda: predict_mask_margin(model, seq, batch_size=SCORE_BATCH)
    first, _, launches, _ = timed_scoring(run, fwd, L, 'mask margin', card)
    scores, ms, _, peak = timed_scoring(run, fwd, L, 'mask margin', card)
    if scores != first:
        fail('mask-margin scores differ from call to call')
    with plain_versions():
        plain = run()
    out = {'mask_margin': {
        'seq_len': SCORE_LEN, 'batch_size': SCORE_BATCH, 'forwards': fwd,
        'launches': launches, 'ms_per_sequence': ms,
        'variants_per_s': len(scores) / ms * 1e3, 'peak_mem_gib': peak,
        'vs_plain': compare_scores(scores, plain, SCORE_MAX_ABS,
                                   f'mask margin, {SCORE_LEN} residues',
                                   card)}}
    log(f'[{card}] mask margin, {SCORE_LEN} residues, batch {SCORE_BATCH}: '
        f'{fwd} forwards, launches {launches}; {ms:.1f} ms a sequence, '
        f'{out["mask_margin"]["variants_per_s"]:.1f} variants/s, peak '
        f'{peak:.2f} GiB; the same bits on a second call')
    pppl, pppl_ms, _, _ = timed_scoring(
        lambda: predict_pseudoperplexity(model, seq, batch_size=SCORE_BATCH),
        fwd, L, 'pseudo-perplexity', card)
    if not (np.isfinite(pppl) and pppl > 1.0):
        fail(f'pseudo-perplexity {pppl}')
    out.update(pseudoperplexity=pppl, pseudoperplexity_ms=pppl_ms)
    log(f'[{card}] pseudo-perplexity, {SCORE_LEN} residues: {pppl:.4f} in '
        f'{pppl_ms:.1f} ms')

    long_seq = seeded_seq(LONG_LEN, 12)
    lfwd = math.ceil(LONG_LEN / SCORE_BATCH)
    long_scores, lms, llaunch, lpeak = timed_scoring(
        lambda: predict_mask_margin(model, long_seq, batch_size=SCORE_BATCH,
                                    max_len=LONG_MAX_LEN),
        lfwd, L, f'mask margin at max_len {LONG_MAX_LEN}', card)

    class Positions(MaskMarginDataset):
        def __init__(self, positions):
            super().__init__(long_seq, max_len=LONG_MAX_LEN,
                             alphabet=model.alphabet)
            self.positions = positions

        def __len__(self):
            return len(self.positions)

        def __getitem__(self, i):
            return super().__getitem__(self.positions[i])
    part = Positions([p for s in LONG_CHECK_STARTS
                      for p in range(s, min(s + SCORE_BATCH, LONG_LEN))])
    got = predict_mask_margin(model, part, batch_size=SCORE_BATCH)
    with plain_versions():
        ref = predict_mask_margin(model, part, batch_size=SCORE_BATCH)
    out['long'] = {
        'seq_len': LONG_LEN, 'max_len': LONG_MAX_LEN, 'forwards': lfwd,
        'launches': llaunch, 'ms_per_sequence': lms,
        'variants_per_s': len(long_scores) / lms * 1e3,
        'peak_mem_gib': lpeak,
        'vs_plain': compare_scores(
            got, ref, SCORE_MAX_ABS, f'mask margin, {LONG_LEN} residues at '
            f'max_len {LONG_MAX_LEN}, batches at {LONG_CHECK_STARTS}', card)}
    log(f'[{card}] mask margin, {LONG_LEN} residues at max_len '
        f'{LONG_MAX_LEN}: {lfwd} forwards of ({SCORE_BATCH}, {LONG_MAX_LEN}),'
        f' {lms:.1f} ms, {out["long"]["variants_per_s"]:.1f} variants/s, '
        f'peak {lpeak:.2f} GiB')

    pep = seeded_seq(PPPL_LEN, 13)
    pfwd = math.ceil(PPPL_LEN * 20 * PPPL_LEN / PPPL_BATCH)
    margin, mms, _, _ = timed_scoring(
        lambda: predict_pseudoperplexity_margin(model, pep,
                                                batch_size=PPPL_BATCH),
        pfwd, L, 'pseudo-perplexity margin', card)
    with plain_versions():
        mref = predict_pseudoperplexity_margin(model, pep,
                                               batch_size=PPPL_BATCH)
    out['pppl_margin'] = {
        'seq_len': PPPL_LEN, 'batch_size': PPPL_BATCH, 'forwards': pfwd,
        'ms': mms, 'vs_plain': compare_scores(
            margin, mref, PPPL_MAX_ABS,
            f'pseudo-perplexity margin, {PPPL_LEN} residues', card)}
    log(f'[{card}] pseudo-perplexity margin, {PPPL_LEN} residues, batch '
        f'{PPPL_BATCH}: {pfwd} forwards, {mms:.1f} ms')
    return out, scores, seq


def write_fasta(path, min_bytes, seed):
    """A FASTA of seeded sequences of 100-1000 residues, 60 a line, until
    the file holds ``min_bytes``; returns the number of sequences."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(AMINO.encode(), np.uint8)
    size = n = 0
    with open(path, 'wb') as f:
        while size < min_bytes:
            lens = rng.integers(100, 1001, 1000)
            res = letters[rng.integers(0, 20, int(lens.sum()))].tobytes()
            parts, lo = [], 0
            for i, m in enumerate(lens):
                s = res[lo:lo + m]
                lo += m
                parts.append(b'>S%07d\n' % (n + i) + b''.join(
                    s[j:j + 60] + b'\n' for j in range(0, m, 60)))
            chunk = b''.join(parts)
            f.write(chunk)
            size += len(chunk)
            n += len(lens)
    return n


def batch_to(dev):
    """A ``Prefetcher`` ``device_put``: the batch's arrays to the card
    from pinned memory, ``non_blocking``."""
    def put(b):
        arrays = {name: torch.from_numpy(getattr(b, name)).pin_memory()
                  .to(dev, non_blocking=True)
                  for name in ('tokens', 'cu_lens', 'masked_tokens', 'mask')}
        return SimpleNamespace(**arrays, max_len=b.max_len)
    return put


class _Head:
    """The first ``n`` items of an indexable dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, min(n, len(ds))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]

    def __iter__(self):
        return (self.ds[i] for i in range(self.n))


def host_pass(items):
    """Host ms a batch over one pass of ``items``."""
    t0 = time.perf_counter()
    n = sum(1 for _ in items)
    return (time.perf_counter() - t0) * 1e3 / n


def busy_share(run):
    """Device busy ms (:func:`_busy_ms`) and wall ms of ``run()`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return _busy_ms(prof.key_averages()), wall


def data_fed_steps(name, cfg, module, dev, card):
    """``MaskedPLM`` steps of ESM2 ``cfg`` (seed-0 weights, Adam) at the
    10k budget fed through ``Prefetcher`` (native reader, one worker,
    ``batch_to``) from ``module``'s train loader, beside the same batches
    built on the card first: ``DATA_STEPS`` steps each after a warm-up,
    ms a step (wall over the steps / steps, and the median step), launches
    exact in the fed run (H1, H2 L a step, H3 2L of which L inverse); the
    device's idle share of each feed from ``PROFILED_STEPS`` more steps
    under the profiler. Losses must be finite."""
    from esme_tpu_torch import Prefetcher
    from esme_tpu_torch.train import MaskedPLM
    model, _ = build_esm2(cfg, dev)
    L = model.config.num_layers
    plm = MaskedPLM(model, learning_rate=1e-4)
    put = batch_to(dev)
    prebuilt = [put(b) for b in _Head(module.train_dataloader(),
                                      DATA_STEPS)]
    torch.cuda.synchronize()
    plm.training_step(prebuilt[0])                    # warm-up

    def steps(batches):
        losses, samples = [], []
        torch.cuda.synchronize()
        t0 = t = time.perf_counter()
        for b in batches:
            losses.append(plm.training_step(b))       # float(): a sync
            now = time.perf_counter()
            samples.append((now - t) * 1e3)
            t = now
        return losses, samples, (t - t0) * 1e3 / len(samples)

    def fed(n=DATA_STEPS):
        return Prefetcher(_Head(module.train_dataloader(), n), depth=2,
                          device_put=put)
    out = {}
    reset_counters()
    losses, samples, wall = steps(fed())
    launches = read_counters()
    expect_launches(f'{name} data-fed steps', launches, **{
        H1_NAME: L * DATA_STEPS, H2_NAME: L * DATA_STEPS,
        H3_NAME: 2 * L * DATA_STEPS, 'rope_inverse': L * DATA_STEPS})
    out['prefetched'] = {'losses': losses, 'ms_per_step': wall,
                         'median_step_ms': float(np.median(samples))}
    losses_p, samples_p, wall_p = steps(prebuilt)
    out['on_card'] = {'losses': losses_p, 'ms_per_step': wall_p,
                      'median_step_ms': float(np.median(samples_p))}
    if not np.isfinite(losses + losses_p).all():
        fail(f'{name}: data-fed losses not finite: {losses}, {losses_p}')
    for key, run in (('prefetched', lambda: steps(fed(PROFILED_STEPS))),
                     ('on_card', lambda: steps(prebuilt[:PROFILED_STEPS]))):
        busy, wall = busy_share(run)
        out[key].update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                        idle_share=1 - busy / wall)
    out['launches'] = launches
    out['real_tokens'] = [int(b.cu_lens[-1]) for b in prebuilt]
    log(f'[{card}] {name} nockpt@{DATA_BUDGET // 1000}k, {DATA_STEPS} '
        f'steps a feed: through Prefetcher {out["prefetched"]["ms_per_step"]:.2f}'
        f' ms a step (median {out["prefetched"]["median_step_ms"]:.2f}, '
        f'idle {out["prefetched"]["idle_share"]:.1%} profiled), batches on '
        f'the card {out["on_card"]["ms_per_step"]:.2f} ms (median '
        f'{out["on_card"]["median_step_ms"]:.2f}, idle '
        f'{out["on_card"]["idle_share"]:.1%}); losses '
        f'{[round(x, 4) for x in losses]}; launches {launches}')
    del plm, model, prebuilt
    torch.cuda.empty_cache()
    return out


def check_data_plane(dev, card, tmp):
    """(c) a seeded FASTA of at least ``DATA_FASTA_BYTES`` indexed with
    ``write_fai``; ``MaskedFastaTokenDataModule`` at the 10k budget on the
    native reader and on the Python reader: every batch of an epoch
    bit-equal, host ms a batch of each reader (timed in that pass: read,
    pack and mask) and of ``Prefetcher`` over the native reader with
    ``DATA_WORKERS`` workers (host only, no copy); then :func:`data_fed_steps` for
    ``DATA_MODELS``."""
    from esme_tpu_torch import MaskedFastaTokenDataModule, Prefetcher
    from esme_tpu_torch.fasta import write_fai
    path = os.path.join(tmp, 'seeded.fa')
    t0 = time.perf_counter()
    n_seqs = write_fasta(path, DATA_FASTA_BYTES, seed=15)
    write_fai(path)
    setup_s = time.perf_counter() - t0
    mods = {use: MaskedFastaTokenDataModule(path, token_per_batch=DATA_BUDGET,
                                            use_native=use)
            for use in (True, False)}
    nat, py = (mods[use].train_dataloader() for use in (True, False))
    if (nat.reader, py.reader) != ('native', 'python'):
        fail(f'the readers taken: {nat.reader}, {py.reader}')
    out = {'fasta_bytes': os.path.getsize(path), 'sequences': n_seqs,
           'write_and_index_s': setup_s, 'batches': len(nat),
           'reader': nat.reader}
    read_s = {'native': 0.0, 'python': 0.0}
    for i in range(len(nat)):
        t0 = time.perf_counter()
        a = nat[i]
        t1 = time.perf_counter()
        b = py[i]
        read_s['native'] += t1 - t0
        read_s['python'] += time.perf_counter() - t1
        for name in ('tokens', 'cu_lens', 'indices', 'masked_tokens',
                     'mask'):
            x, y = getattr(a, name), getattr(b, name)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                fail(f'batch {i}: {name} of the native reader differs from '
                     "the Python reader's")
        if a.max_len != b.max_len:
            fail(f'batch {i}: max_len {a.max_len} != {b.max_len}')
    out['host_ms_per_batch'] = {
        **{key: v * 1e3 / len(nat) for key, v in read_s.items()},
        **{f'prefetcher_{w}_workers': host_pass(Prefetcher(
            mods[True].train_dataloader(), num_workers=w))
           for w in DATA_WORKERS}}
    log(f'[{card}] data plane: {out["fasta_bytes"]:,} B FASTA, {n_seqs} '
        f'sequences of 100-1000 residues, written and indexed in '
        f'{setup_s:.1f} s; {len(nat)} batches at {DATA_BUDGET}, the native '
        "reader's bit-equal to the Python reader's; host ms a batch "
        f'{out["host_ms_per_batch"]}')
    module = mods[True]
    out['steps'] = {name: data_fed_steps(name, cfg, module, dev, card)
                    for name, cfg in DATA_MODELS}
    return out


def check_extension(dev, card):
    """(e) ESM1b at full width and depth, seed 5, with the published
    table of ``ESM1B_POSITIONS``: a seeded 500-residue sequence's
    log-probs bit-equal before and after ``extend_positions(model,
    4096)``; a 3,000-residue forward refused before and run after (launches
    exact: H1 L, no H3), finite and normalised; one ``MaskedPLM`` step
    under ``positions_only_mask`` on sequences of ``EXTEND_TRAIN_LENS``
    (H1 L, H2 L, no H3): ``embed_positions`` changes, every other leaf
    keeps its bits."""
    from dataclasses import replace
    from esme_tpu_torch import ESM1b, tokenize_unpad
    from esme_tpu_torch.alphabet import mask_tokens, pack_tokens
    from esme_tpu_torch.extend import extend_positions, positions_only_mask
    from esme_tpu_torch.models.config import esm1b_config
    from esme_tpu_torch.train import MaskedPLM
    cfg = replace(esm1b_config(), learned_positions=ESM1B_POSITIONS)
    model = ESM1b(config=cfg, rng=5, device=dev)
    L = cfg.num_layers

    def logp(seq):
        tok, _, cu, ml = tokenize_unpad([seq], alphabet=model.alphabet)
        return model.predict_log_prob(tok, pad_args=(cu, ml))
    short, long = seeded_seq(EXTEND_SHORT, 21), seeded_seq(EXTEND_LONG, 22)
    before = logp(short)
    try:
        logp(long)
    except ValueError:
        pass
    else:
        fail(f'a {EXTEND_LONG}-residue forward ran on a table of '
             f'{ESM1B_POSITIONS} positions')
    extend_positions(model, EXTEND_TO, rng=0)
    rows = model.params['embed_positions'].shape[0]
    after = logp(short)
    if rows != EXTEND_TO + 2 or not torch.equal(before, after):
        fail(f'extend_positions: {rows} rows; {EXTEND_SHORT}-residue '
             f'log-probs bit-equal {torch.equal(before, after)}')
    torch.cuda.synchronize()
    reset_counters()
    lp = logp(long)
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches(f'ESM1b {EXTEND_LONG}-residue forward', launches,
                    **{H1_NAME: L})
    lse = lp.logsumexp(-1).abs().max().item()
    if not torch.isfinite(lp).all() or lse > LOGSUMEXP_ATOL:
        fail(f'ESM1b {EXTEND_LONG} residues: log-probs not normalised')

    seqs = [seeded_seq(n, 30 + i) for i, n in enumerate(EXTEND_TRAIN_LENS)]
    tokens, _, cu, max_len = pack_tokens(seqs, DATA_BUDGET,
                                         alphabet=model.alphabet)
    masked, mask = mask_tokens(tokens[None], alphabet=model.alphabet,
                               rng=np.random.default_rng(1))
    mask[0, cu[-1]:] = False
    batch = SimpleNamespace(tokens=tokens, masked_tokens=masked[0],
                            mask=mask[0], cu_lens=cu, max_len=max_len)
    snapshot = {name: a.clone() for name, a, _ in
                _leaf_pairs(model.params, model.params)}
    plm = MaskedPLM(model, learning_rate=1e-4,
                    trainable_mask=positions_only_mask(model.params))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    loss = plm.training_step(batch)
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches = read_counters()
    expect_launches('ESM1b positions-only step', step_launches,
                    **{H1_NAME: L, H2_NAME: L})
    changed = [name for name, a, _ in _leaf_pairs(model.params,
                                                   model.params)
               if not torch.equal(a, snapshot[name])]
    moved = int((model.params['embed_positions'] != snapshot[
        'embed_positions']).any(-1).sum())
    log(f'[{card}] ESM1b ({L} layers, width {cfg.embed_dim}, table '
        f'{ESM1B_POSITIONS} -> {EXTEND_TO}): {EXTEND_SHORT}-residue log-probs bit-equal after '
        f'the extension; {EXTEND_LONG}-residue forward launches {launches}, '
        f'max|logsumexp| {lse:.2e}; a positions-only step on '
        f'{EXTEND_TRAIN_LENS} residues: loss {loss:.4f}, {step_ms:.1f} ms, '
        f'launches {step_launches}, leaves changed {changed} ({moved} rows)')
    if changed != ['embed_positions'] or not np.isfinite(loss):
        fail(f'the positions-only step changed {changed} (loss {loss})')
    del plm, model, snapshot
    torch.cuda.empty_cache()
    return {'positions': [ESM1B_POSITIONS, EXTEND_TO],
            'long_launches': launches, 'step_launches': step_launches,
            'step_ms': step_ms, 'loss': loss, 'rows_moved': moved}


def check_cli(path, seq, scores, card):
    """(f) ``python -m esme_tpu_torch.cli score`` in its own process on the
    phase's safetensors file and (a)'s sequence: its CSV must hold
    ``variant,score`` and 5,300 rows equal to (a)'s scores (the same bits:
    the same weights, batches and kernels). Its wall time includes the
    interpreter, the load and the kernels' libraries."""
    import csv
    out_csv = path + '.csv'
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, '-m', 'esme_tpu_torch.cli',
                          'score', '--model', path, '--seq', seq,
                          '--batch-size', str(SCORE_BATCH), '--out',
                          out_csv], cwd=root, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f'the CLI failed: {run.stderr[-2000:]}')
    with open(out_csv, newline='') as f:
        rows = list(csv.reader(f))
    got = {v: float(s) for v, s in rows[1:]}
    equal = rows[0] == ['variant', 'score'] and got == scores
    err = max((abs(got[v] - s) for v, s in scores.items() if v in got),
              default=float('nan'))
    log(f'[{card}] CLI score: {len(rows) - 1} rows in {wall:.1f} s wall '
        f'(start, load, scoring); equal to (a) {equal} (max|Δ| {err:.3e})')
    if not equal or len(rows) - 1 != len(scores):
        fail('the CLI\'s CSV differs from (a)\'s scores')
    return {'rows': len(rows) - 1, 'wall_s': wall}


def check_phase15(dev, card):
    """Phase 15: (a), (b) :func:`check_scoring` on ESM2-650M loaded from its
    seeded safetensors file; (c) :func:`check_data_plane`; (d) phase 13's
    embedding gate (reported there); (e) :func:`check_extension`; (f)
    :func:`check_cli`. Each part's seconds are logged."""
    out, seconds = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        log(f'[{card}] phase 15 {key}: {seconds[key]:.1f} s')

    with tempfile.TemporaryDirectory() as tmp:
        model, _ = family_model('esm2_650m', 'ESM2', MODEL, 0, dev, tmp,
                                keep=True)
        path = os.path.join(tmp, 'esm2_650m.safetensors')
        timed('a_b_scoring', lambda: check_scoring(model, card))
        out['a_b_scoring'], scores, seq = out['a_b_scoring']
        del model
        torch.cuda.empty_cache()
        timed('f_cli', lambda: check_cli(path, seq, scores, card))
        os.remove(path)
        timed('c_data_plane', lambda: check_data_plane(dev, card, tmp))
    timed('e_extension', lambda: check_extension(dev, card))
    out['seconds'] = seconds
    return out


# -------------------------------------------------------------------------
# Phase 16: weight quantization (esme_tpu_torch/quant.py) at ESM2-650M's
# full width, from seed-0 weights written through the safetensors schema
# (phase 15's file): quantize-at-load, the quantized forward (H1, H3), a
# QLoRA step (H1, H2, H3), the quantized file's round trip. ESM2-15B's
# capacity run is part of phase 12 (SIZE_QUANTIZE).
QUANT_MODES = ('8bit', '4bit')
# the per-token cosine of the quantized model's log-probs against the dense
# model's on the same weights, uncentred: the JAX package's own thresholds
# and form (benchmarks/quant_accuracy.py:40, its all(sim > t))
QUANT_MIN_COS = {'8bit': 0.999, '4bit': 0.99}
# device memory after a quantize-at-load, over the leaves' own bytes: the
# allocator's rounding and the loader's stacking; a dense copy of the
# linears on the card would add 100% (int8) to 250% (NF4)
QUANT_LOAD_SLACK = 0.05
# benchmarks/quant_accuracy.py --outliers: 8 random input rows of every
# attention and MLP linear scaled 20x, seed 7 (inject_outliers, copied).
# Its thresholds hold its own cell (quant_accuracy_cell): JAX's seed-0
# draw of the weights, not phase 15's, since under the injection the
# cosine is the draw's (tests/torch_quant_witness.py: both packages read
# the same value on either draw, and int8 falls below 0.999 on some)
OUTLIER_ROWS, OUTLIER_FACTOR, OUTLIER_SEED = 8, 20.0, 7
QUANT_REGIMES = ('randn', 'outlier')
# (b)'s other family: ESMC-300M as phase 9 seeds it (its first run), 4bit
QUANT_FAMILY = ('esmc_300m', 'ESMC', {})
# dequant_ms' chunks: linears a chunk (an NF4 dequantization is up to 7
# launches) and the spin queued ahead of each, ~25 ms at the H100's 1.98 GHz
# boost clock, above the host's enqueue of a chunk
DEQUANT_CHUNK = 66
DEQUANT_SPIN_CYCLES = 50_000_000
# phase 12 (f): a size quantized on the card after its bf16 inference cell,
# then the same cell again
SIZE_QUANTIZE = {'esm2_15b': '4bit'}
# the linears that quantize_model_params quantizes
QUANT_LINEARS = ('q', 'k', 'v', 'out', 'fc1', 'fc2', 'gate', 'up', 'down')


def _named_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


def quant_bytes(params):
    """(bytes of the quantized linears' storage, bytes of every other
    leaf) of a params tree."""
    from esme_tpu_torch.quant import NON_TRAINABLE_QUANT_LEAVES
    q = other = 0
    for name, t in _named_leaves(params):
        n = t.numel() * t.element_size()
        parts = name.split('.')
        if parts[-1] in NON_TRAINABLE_QUANT_LEAVES and len(parts) > 1 \
                and parts[-2] in QUANT_LINEARS:
            q += n
        else:
            other += n
    return q, other


def dense_linears(params):
    """The attention and MLP linears that still hold a dense kernel."""
    return [f'{grp}.{name}' for grp, sub in params['layers'].items()
            for name, p in sub.items()
            if name in QUANT_LINEARS and 'kernel' in p]


_M32 = 0xFFFFFFFF
# elements a chunk of jax_seed_params' draws (int64 counters: 128 MiB each)
JAX_DRAW_CHUNK = 1 << 24


def _threefry2x32(key, x0, x1):
    """JAX's threefry2x32 block cipher (``jax._src.prng``) of the counter
    words ``x0``, ``x1`` (int64 tensors holding uint32 values) under
    ``key``, a pair of ints."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _jax_split(key, n):
    """``jax.random.split(key, n)``'s key words (partitionable threefry,
    JAX's default)."""
    b1, b2 = _threefry2x32(key, torch.zeros(n, dtype=torch.int64),
                           torch.arange(n, dtype=torch.int64))
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def _jax_draw(key, shape, kind, scale, dtype, device):
    """``(jax.random.<kind>(key, ..., shape, float32) * scale)
    .astype(dtype)``, ``kind`` 'truncated_normal' (at ±2) or 'normal':
    JAX's counter bits and uniforms bit for bit, its ``erf_inv`` as
    fp64's rounded to fp32 (XLA's fp32 approximation differs by a few
    ulps: about 1 bf16 weight in 20,000 lands an ulp away, and weights
    near 0 ~1e-9 away)."""
    sqrt2 = torch.tensor(math.sqrt(2), dtype=torch.float32, device=device)
    if kind == 'truncated_normal':
        # erf(∓2/√2) in fp32, as XLA computes it
        lo, hi = np.float32(-0.9544997), np.float32(0.9544997)
        clip = (float(np.nextafter(np.float32(-2), np.float32(np.inf))),
                float(np.nextafter(np.float32(2), np.float32(-np.inf))))
    else:
        lo, hi, clip = np.nextafter(np.float32(-1), np.float32(0)), \
            np.float32(1), None
    lo_t, hi_t = (torch.tensor(v, dtype=torch.float32, device=device)
                  for v in (lo, hi))
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, JAX_DRAW_CHUNK):
        i = torch.arange(start, min(n, start + JAX_DRAW_CHUNK),
                         dtype=torch.int64, device=device)
        b1, b2 = _threefry2x32(key, i >> 32, i & _M32)
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        u = bits.to(torch.int32).view(torch.float32) - 1.0
        u = torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)
        x = sqrt2 * torch.erfinv(u.double()).float()
        if clip is not None:
            x = x.clamp(*clip)
        out[start:start + i.numel()] = (x * scale).to(dtype)
    return out.reshape(shape)


def jax_seed_params(cfg, seed, device):
    """The JAX package's ``ESM2(config=cfg, rng=seed).params``
    (``esme_tpu/models/init.py``: ESM2's tree, GELU MLP, no position
    table), drawn on ``device`` through JAX's PRNG reproduced here (no
    JAX): ``benchmarks/quant_accuracy.py``'s weights at ``seed`` 0."""
    keys = iter(_jax_split((0, seed), 16))
    dt = cfg.torch_dtype
    D, F, L, V = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers, cfg.vocab_size

    def lin(d_in, d_out, stacked=None):
        shape = (d_in, d_out) if stacked is None else (stacked, d_in, d_out)
        p = {'kernel': _jax_draw(next(keys), shape, 'truncated_normal',
                                 d_in ** -0.5, dt, device)}
        if cfg.bias or stacked is None:
            p['bias'] = torch.zeros(shape[:-2] + (d_out,), dtype=dt,
                                    device=device)
        return p

    def norm(bias=True, stacked=None):
        shape = (D,) if stacked is None else (stacked, D)
        p = {'scale': torch.ones(shape, dtype=dt, device=device)}
        if bias:
            p['bias'] = torch.zeros(shape, dtype=dt, device=device)
        return p

    emb = _jax_draw(next(keys), (V, D), 'normal', 0.02, dt, device)
    emb[cfg.padding_idx] = 0
    attn = {'norm': norm(cfg.norm_bias, L)}
    attn.update({n: lin(D, D, L) for n in ('q', 'k', 'v', 'out')})
    mlp = {'norm': norm(cfg.norm_bias, L), 'fc1': lin(D, F, L),
           'fc2': lin(F, D, L)}
    return {'embed_tokens': emb, 'layers': {'attn': attn, 'mlp': mlp},
            'emb_norm_after': norm(cfg.final_ln_bias),
            'lm_head': {'dense': lin(D, D), 'norm': norm(),
                        'final': lin(D, V)}}


def inject_outliers(params, cfg, n_rows=OUTLIER_ROWS, factor=OUTLIER_FACTOR,
                    seed=OUTLIER_SEED):
    """``benchmarks/quant_accuracy.py:inject_outliers``, copied: ``n_rows``
    random input rows of every attention and MLP linear (the same rows in
    every layer) scaled by ``factor``, the product in fp32."""
    rng = np.random.default_rng(seed)

    def scale_kernel(k):
        d_in = k.shape[-2]
        rows = rng.choice(d_in, size=min(n_rows, d_in), replace=False)
        mult = torch.ones((d_in, 1), dtype=torch.float32, device=k.device)
        mult[torch.as_tensor(rows, device=k.device)] = factor
        return (k.float() * mult).to(k.dtype)

    params = dict(params)
    layers = {k: dict(v) for k, v in params['layers'].items()}
    names = {'attn': ('q', 'k', 'v', 'out'),
             'mlp': ('gate', 'up', 'down') if cfg.mlp == 'swiglu'
             else ('fc1', 'fc2')}
    for grp, lin_names in names.items():
        for name in lin_names:
            lin = dict(layers[grp][name])
            lin['kernel'] = scale_kernel(lin['kernel'])
            layers[grp][name] = lin
    params['layers'] = layers
    return params


def quant_load(path, mode, dev, card):
    """(a) ``ESM.from_pretrained(path, quantization=mode)``: the load's
    seconds, the leaves' bytes, the device memory it left allocated and
    its peak, each over what was allocated before it; both within
    ``QUANT_LOAD_SLACK`` of the leaves' bytes, every linear quantized."""
    from esme_tpu_torch import ESM
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ESM.from_pretrained(path, quantization=mode, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    alloc = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    q, other = quant_bytes(model.params)
    limit = (q + other) * (1 + QUANT_LOAD_SLACK)
    out = {'load_s': load_s, 'quantized_bytes': q, 'other_bytes': other,
           'allocated_bytes': alloc, 'peak_bytes': peak,
           'limit_bytes': limit}
    log(f'[{card}] {mode} quantize-at-load of ESM2-650M: {load_s:.1f} s; '
        f'quantized leaves {q / 2**20:.1f} MiB, dense leaves '
        f'{other / 2**20:.1f} MiB; device memory after the load '
        f'{alloc / 2**20:.1f} MiB, its peak {peak / 2**20:.1f} MiB (gate '
        f'{limit / 2**20:.1f} MiB)')
    if dense_linears(model.params):
        fail(f'{mode} load: dense linears {dense_linears(model.params)}')
    if alloc > limit or peak > limit:
        fail(f'{mode} load: {alloc} B allocated, peak {peak} B, above the '
             f'leaves\' {q + other} B and {QUANT_LOAD_SLACK:.0%}')
    return model, out


def quantize_card_vs_cpu(dense, mode, card):
    """(a) ``quantize(mode)`` of the dense model on the card, bit-equal leaf
    by leaf (dtypes included) to the same call on the CPU over the same
    weights. Returns the card's model and the seconds of each."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.train.trainer import _map
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qm = ESM2(config=dense.config, params=dense.params,
              device=dense.device).quantize(mode)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = ESM2(config=dense.config, params=_map(
        lambda t: t.cpu(), dense.params), device='cpu')
    t0 = time.perf_counter()
    cpu.quantize(mode)
    cpu_s = time.perf_counter() - t0
    n = 0
    for leaf, a, b in _leaf_pairs(qm.params, cpu.params):
        n += 1
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            fail(f'{mode} quantize(): {leaf} on the card differs from the '
                 f'CPU ({a.dtype}, {b.dtype})')
    log(f'[{card}] {mode} quantize() on the card {card_s:.2f} s, on the CPU '
        f'{cpu_s:.2f} s: {n} leaves bit-equal, dtypes included')
    return qm, {'card_s': card_s, 'cpu_s': cpu_s, 'leaves': n}


def routes_agree(loaded, quantized, mode, card):
    """Which linears the streaming load and ``quantize()`` quantize to the
    same leaves, and to the same dequantized weights in every layer (the
    JAX package's twins disagree on tied NF4 row maxima: ROADMAP.md Queue
    3, item 23); logged, not gated."""
    from esme_tpu_torch.quant import NON_TRAINABLE_QUANT_LEAVES, dequantize
    out = {'same_leaves': [], 'same_weights': [], 'differ': []}
    for grp, sub in quantized.params['layers'].items():
        for name, p in sub.items():
            if name not in QUANT_LINEARS:
                continue
            q = loaded.params['layers'][grp][name]
            what = f'{grp}.{name}'
            if all(torch.equal(q[k].float(), p[k].float())
                   for k in NON_TRAINABLE_QUANT_LEAVES if k in p):
                out['same_leaves'].append(what)
            elif torch.equal(dequantize(q), dequantize(p)):
                out['same_weights'].append(what)
            else:
                out['differ'].append(what)
    log(f'[{card}] {mode}: the streaming load and quantize() give the same '
        f'leaves for {out["same_leaves"]}, other leaves but the same '
        f'weights for {out["same_weights"]}, other weights for '
        f'{out["differ"]}')
    return out


def quant_cos(lp, ref, mode, what, card):
    """The quantized model's log-probs against the dense model's, per real
    token: uncentred cosine (min over tokens) under ``QUANT_MIN_COS``; the
    centred cosine and max|Δ| logged."""
    cos = (lp * ref).sum(-1) / (lp.norm(dim=-1) * ref.norm(dim=-1)) \
        .clamp_min(1e-9)
    a, b = lp - lp.mean(-1, keepdim=True), ref - ref.mean(-1, keepdim=True)
    ccos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    out = {'min_cos': cos.min().item(), 'mean_cos': cos.mean().item(),
           'min_centred_cos': ccos.min().item(),
           'max_abs': (lp - ref).abs().max().item()}
    finite = bool(torch.isfinite(lp).all())
    ok = out['min_cos'] > QUANT_MIN_COS[mode] and finite
    log(f'[{card}] {what}, {mode} vs dense: per-token cosine min '
        f'{out["min_cos"]:.6f} (gate > {QUANT_MIN_COS[mode]}), mean '
        f'{out["mean_cos"]:.6f}; centred min {out["min_centred_cos"]:.6f}, '
        f'max|Δ| {out["max_abs"]:.4f} {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{what}: the {mode} model is out of gate against the dense')
    return out


def small_logp(model, batch=None):
    """Log-probs of the real tokens of the 4k batch (phase 4's) or of
    ``batch``."""
    stok, scu, sml = batch or packed_batch(SMALL_BUDGET, seed=2)
    return model.predict_log_prob(stok, pad_args=(scu, sml))[:int(scu[-1])]


def script_batch(T=8192):
    """``benchmarks/quant_accuracy.py``'s batch, copied: 514-token
    sequences (cls, 512 residues from seed 0, eos) packed into ``T``."""
    from esme_tpu_torch.alphabet import Alphabet
    rng = np.random.default_rng(0)
    lens, total = [], 0
    while total + 514 <= T - 128:
        lens.append(514)
        total += 514
    cu = np.cumsum([0, *lens]).astype(np.int32)
    tokens = np.full(T, Alphabet.padding_idx, np.int32)
    tokens[:cu[-1]] = rng.integers(4, 24, cu[-1])
    for i in range(len(lens)):
        tokens[cu[i]] = Alphabet.cls_idx
        tokens[cu[i + 1] - 1] = Alphabet.eos_idx
    return tokens, cu, 514


def quant_correctness(dense, models, what, card):
    """(b) each quantized model through phase 4's comparisons on the 4k
    batch (launches exact: H1 and H3 once a layer, no H2) and against the
    dense model on the same weights."""
    out = {}
    ref = small_logp(dense)
    for mode, model in models.items():
        out[mode] = {'vs_dense': quant_cos(small_logp(model), ref, mode,
                                           what, card),
                     'model_checks': plain_checks(model, f'{what} {mode}: ')}
    del ref
    torch.cuda.empty_cache()
    return out


def quant_accuracy_cell(dev, card):
    """(b) ``benchmarks/quant_accuracy.py``'s own cell: its weights (JAX's
    seed-0 ESM2-650M, :func:`jax_seed_params`) and its batch
    (:func:`script_batch`), without and with its outlier injection
    (:func:`inject_outliers`); each mode against the dense model on the
    same weights under its thresholds (``QUANT_MIN_COS``)."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.models.config import esm2_config
    cfg = esm2_config(**MODEL)
    batch = script_batch()
    base = jax_seed_params(cfg, 0, dev)
    out = {}
    for regime in QUANT_REGIMES:
        params = base if regime == 'randn' else inject_outliers(base, cfg)
        ref = small_logp(ESM2(config=cfg, params=params, device=dev), batch)
        for mode in QUANT_MODES:
            q = ESM2(config=cfg, params=params, device=dev).quantize(mode)
            out[f'{regime}_{mode}'] = quant_cos(
                small_logp(q, batch), ref, mode,
                f'quant_accuracy.py\'s cell, JAX\'s seed-0 draw, {regime}',
                card)
            del q
        del ref, params
    del base
    torch.cuda.empty_cache()
    return out


def dequant_ms(model, card, mode):
    """One forward's dequantization, every quantized linear of every layer
    through ``dequantize`` to bf16: its device ms on the card alone and
    with the host in it (CUDA events around back-to-back loops), beside
    the bound of its bytes (the storage read once, the bf16 kernels
    written once). On the card alone: ``DEQUANT_CHUNK`` linears at a time,
    each chunk behind a spin of ``DEQUANT_SPIN_CYCLES`` (the host's
    enqueue overlaps the spin; the launch queue holds about a thousand
    launches, so a chunk stays well under it), the chunks' device times
    summed; the fastest of three. Fails if a host enqueue outlasts its
    spin."""
    from esme_tpu_torch.models.modules import layer_params, num_layers
    from esme_tpu_torch.quant import dequantize
    stacked = model.params['layers']
    layers = [layer_params(stacked, i) for i in range(num_layers(stacked))]
    lins = [p for layer in layers for grp in layer.values()
            for name, p in grp.items() if name in QUANT_LINEARS]

    def run(ps=lins):
        for p in ps:
            dequantize(p, torch.bfloat16)
    with_host = cuda_ms(run, reps=3, warmup=1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    alone = []
    for _ in range(3):
        total = 0.0
        for c in range(0, len(lins), DEQUANT_CHUNK):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            torch.cuda._sleep(DEQUANT_SPIN_CYCLES)
            ev[1].record()
            run(lins[c:c + DEQUANT_CHUNK])
            host = (time.perf_counter() - t0) * 1e3
            ev[2].record()
            torch.cuda.synchronize()
            if host >= ev[0].elapsed_time(ev[1]):
                fail(f'{mode} dequantization: the host\'s enqueue of '
                     f'{DEQUANT_CHUNK} linears ({host:.1f} ms) outlasted the '
                     f'spin ahead of it ({ev[0].elapsed_time(ev[1]):.1f} ms)')
            total += ev[1].elapsed_time(ev[2])
        alone.append(total)
    ms = min(alone)
    q, _ = quant_bytes(model.params)
    weights = sum(p['qvalue'].numel() * (2 if mode == '4bit' else 1)
                  for p in lins)
    nbytes = q + 2 * weights
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f'[{card}] {mode} dequantization of one forward ({len(lins)} '
        f'linears, {weights:,} weights): {ms:.3f} ms on the card alone '
        f'(calls {[round(x, 3) for x in alone]}), {with_host:.3f} ms with '
        f'the host\'s enqueue; bound {bound_ms:.3f} ms by bytes '
        f'({nbytes / 1e9:.3f} GB)')
    return {'ms': ms, 'ms_calls': alone, 'ms_with_host': with_host,
            'bound_ms': bound_ms, 'bytes': nbytes, 'weights': weights}


def quant_times(dense, models, card, profile_dir=None):
    """(c) the 50k inference cell of the dense model and of each quantized
    one in turns (dense, 8bit, 4bit, dense; launches exact), each
    quantized forward's dequantization alone, and ``predict_mask_margin``
    on phase 15's 265-residue sequence, dense and 4bit."""
    from esme_tpu_torch.variant import predict_mask_margin
    batch = packed_batch(BUDGET, seed=0)
    L = dense.config.num_layers
    out = {'launches': {}}
    for mode, model in models.items():
        out['launches'][mode] = inference_run(
            model, batch, f'{mode} inference', expected_launches(
                **{H1_NAME: L, H3_NAME: L}))
    order = [('dense', dense), *models.items(), ('dense_again', dense)]
    out['inference'] = {key: inference_times(m, batch, f'[{card}] {key} '
                                             'inference')
                        for key, m in order}
    out['dequant'] = {mode: dequant_ms(m, card, mode)
                      for mode, m in models.items()}
    if profile_dir:
        tokens, cu, max_len = batch
        for mode, m in models.items():
            _profile(lambda m=m: m.predict_log_prob(
                tokens, pad_args=(cu, max_len)), profile_dir,
                f'profile_quant_{mode}.txt', f'{mode} forward')
    seq = seeded_seq(SCORE_LEN, 11)
    fwd = math.ceil(SCORE_LEN / SCORE_BATCH)
    scores = {}
    for key, m in (('dense', dense), ('4bit', models['4bit'])):
        run = lambda m=m: predict_mask_margin(m, seq, batch_size=SCORE_BATCH)
        timed_scoring(run, fwd, L, f'{key} mask margin', card)
        scores[key], ms, _, peak = timed_scoring(
            run, fwd, L, f'{key} mask margin', card)
        out[f'mask_margin_{key}'] = {
            'ms_per_sequence': ms, 'peak_mem_gib': peak,
            'variants_per_s': len(scores[key]) / ms * 1e3}
    from esme_tpu_torch.metrics import spearman
    a, b = _score_arrays(scores['4bit'], scores['dense'])
    out['mask_margin_4bit']['spearman_vs_dense'] = spearman(a, b)
    for key in ('dense', '4bit'):
        c = out[f'mask_margin_{key}']
        log(f'[{card}] mask margin ({SCORE_LEN} residues, {fwd} forwards) '
            f'{key}: {c["ms_per_sequence"]:.2f} ms a sequence, '
            f'{c["variants_per_s"]:.1f} variants/s, peak '
            f'{c["peak_mem_gib"]:.2f} GiB')
    log(f'[{card}] 4bit scores against dense: Spearman ρ '
        f'{out["mask_margin_4bit"]["spearman_vs_dense"]:.6f} (logged)')
    return out


def check_qlora(nf4, card, phase5):
    """(d) phase 14's ``gb1_265`` ``RegressionTrainer`` step over an NF4
    trunk, ``nf4`` (``quantize('4bit')`` of the seed-0 weights on the
    card; the phase's other models freed, so its peak is comparable to
    phase 14's), with LoRA rank 16 on query, value and output (every
    ``b`` lifted) and the 4-head aggregation head; the gradients against
    the plain versions under phase 14's rule, no quantized leaf with a
    gradient, then the step's times."""
    model = ft_model(nf4.device, lift_b=True, model=nf4)
    head = ft_head(nf4.device)
    batch = length_batch(model, FT_LENGTHS['gb1_265'])
    out = {'grads': check_finetune_grads(model, head, batch, card, 'gb1_265',
                                         label='gb1_265_nf4'),
           'times': time_finetune(model, head, batch, card, phase5,
                                  'gb1_265', label='gb1_265_nf4')}
    del model, head, batch
    torch.cuda.empty_cache()
    return out


def quant_round_trip(model, tmp, card):
    """(e) ``save_pretrained`` of an NF4 model and ``ESM.from_pretrained``
    back: every leaf bit-equal (dtypes included) and the 4k batch's
    log-probs bit for bit; the same file without its ``qoutlier_*`` keys
    refused with ``ValueError``."""
    from esme_tpu_torch import ESM
    from esme_tpu_torch.models.io import read_safetensors, write_safetensors
    path = os.path.join(tmp, 'esm2_650m_nf4.safetensors')
    t0 = time.perf_counter()
    model.save_pretrained(path, name='esm2_650m')
    back = ESM.from_pretrained(path, device=model.device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for leaf, a, b in _leaf_pairs(back.params, model.params):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f'NF4 round trip: {leaf} changed')
    if not torch.equal(small_logp(back), small_logp(model)):
        fail('NF4 round trip: the log-probs changed')
    flat, meta = read_safetensors(path)
    size = os.path.getsize(path)
    write_safetensors(path, {k: v for k, v in flat.items()
                             if '.qoutlier_' not in k}, meta)
    try:
        ESM.from_pretrained(path, device=model.device)
        fail('NF4 file without its qoutlier_* keys loaded')
    except ValueError as e:
        refused = str(e).split(';')[0]
    os.remove(path)
    log(f'[{card}] NF4 save and load: {size / 2**20:.1f} MiB file, '
        f'{secs:.1f} s, every leaf and the log-probs bit-equal; without '
        f'its outlier keys refused ({refused})')
    return {'file_bytes': size, 'seconds': secs, 'metadata': {
        k: meta.get(k) for k in ('quantization', 'qscheme')}}


def check_quant(dev, card, phase5, finetune, scoring, profile_dir=None):
    """Phase 16: (a) quantize-at-load of ESM2-650M in both modes and
    ``quantize()`` on the card against the CPU; (b) the quantized models
    against their plain versions and the dense model, ``quant_accuracy.py``'s
    cell (also after ``inject_outliers``), and ESMC-300M in 4bit; (c)
    times; (d) the QLoRA step; (e) the NF4 round trip. Each part's seconds
    are logged."""
    from esme_tpu_torch import ESM
    out, seconds = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        log(f'[{card}] phase 16 {key}: {seconds[key]:.1f} s')

    with tempfile.TemporaryDirectory() as tmp:
        dense, _ = family_model('esm2_650m', 'ESM2', MODEL, 0, dev, tmp,
                                keep=True)
        path = os.path.join(tmp, 'esm2_650m.safetensors')
        loaded, cards = {}, {}

        def part_a():
            res = {}
            for mode in QUANT_MODES:
                loaded[mode], res[f'load_{mode}'] = quant_load(path, mode,
                                                               dev, card)
            for mode in QUANT_MODES:
                cards[mode], res[f'quantize_{mode}'] = quantize_card_vs_cpu(
                    dense, mode, card)
                res[f'routes_{mode}'] = routes_agree(loaded[mode],
                                                     cards[mode], mode, card)
            return res
        timed('a_load', part_a)
        os.remove(path)
        timed('b_esm2', lambda: quant_correctness(dense, loaded, 'ESM2-650M',
                                                  card))

        timed('b_quant_accuracy', lambda: quant_accuracy_cell(dev, card))

        def esmc():
            name, cls_name, kwargs = QUANT_FAMILY
            src, _ = family_model(name, cls_name, kwargs, 0, dev, tmp,
                                  keep=True)
            fpath = os.path.join(tmp, f'{name}.safetensors')
            q = ESM.from_pretrained(fpath, quantization='4bit', device=dev)
            os.remove(fpath)
            res = quant_correctness(src, {'4bit': q}, name, card)
            del src, q
            return res
        timed('b_esmc', esmc)
        timed('c_times', lambda: quant_times(dense, loaded, card,
                                             profile_dir))
        timed('e_round_trip', lambda: quant_round_trip(cards['4bit'], tmp,
                                                       card))
    nf4 = cards.pop('4bit')
    del dense, loaded, cards
    torch.cuda.empty_cache()
    timed('d_qlora', lambda: check_qlora(nf4, card, phase5))
    del nf4
    torch.cuda.empty_cache()
    c, d = out['c_times'], out['d_qlora']['times']
    inf = c['inference']
    ft = finetune['d_times']['gb1_265']
    log(f'[{card}] phase 16 summary: 50k forward dense '
        f'{inf["dense"]["ms_per_batch"]:.2f} / {inf["dense_again"]["ms_per_batch"]:.2f} ms, '
        f'8bit {inf["8bit"]["ms_per_batch"]:.2f} ms '
        f'({inf["8bit"]["real_tokens_per_s"]:.1f} real tokens/s, '
        f'{inf["8bit"]["peak_mem_gib"]:.2f} GiB), 4bit '
        f'{inf["4bit"]["ms_per_batch"]:.2f} ms '
        f'({inf["4bit"]["real_tokens_per_s"]:.1f}, '
        f'{inf["4bit"]["peak_mem_gib"]:.2f} GiB); dequantization 8bit '
        f'{c["dequant"]["8bit"]["ms"]:.3f} ms, 4bit '
        f'{c["dequant"]["4bit"]["ms"]:.3f} ms a forward; mask margin 4bit '
        f'{c["mask_margin_4bit"]["ms_per_sequence"]:.2f} ms against dense '
        f'{c["mask_margin_dense"]["ms_per_sequence"]:.2f} (phase 15: '
        f'{scoring["mask_margin"]["ms_per_sequence"]:.2f}); QLoRA step '
        f'{d["ms_per_step"]:.2f} ms ({d["real_tokens_per_s"]:.1f} real '
        f'tokens/s, peak {d["peak_mem_gib"]:.2f} GiB, optimizer '
        f'{d["optimizer_state_bytes"]:,} B) against the dense LoRA step '
        f'{ft["ms_per_step"]:.2f} ms ({ft["peak_mem_gib"]:.2f} GiB, phase 14)')
    out['seconds'] = seconds
    return out


# Phase 17: LoRA, trainable masks and QLoRA over the mesh
# (ShardedMaskedPLM with adapters) and the masked-LM trainers' state
# through CheckpointManager. (a) and (b) run on phase 5's nockpt@10k batch
# in a one-rank NCCL world; each trainer takes 1 + LORA_REPS steps, after
# which its frozen leaves are held bit-unchanged. (c) cuts a run after
# RESUME_CUT steps and holds the next step of a restored trainer bit-equal
# to the uninterrupted one.
LORA_REPS = 5
RESUME_CUT = 2
# phase 12 (g): a size's QLoRA step, on its quantized model (SIZE_QUANTIZE)
# with phase 14's adapters, checkpointing on (remat='full')
SIZE_QLORA = ('esm2_15b',)
SIZE_QLORA_REPS = 3


def lora_model(dev, quant=None):
    """ESM2 at ``MODEL`` (bf16, seed-0 weights) with phase 14's adapters
    (rank 16 on query, value and output, every ``b`` lifted), its trunk
    quantized on the card to ``quant`` first (None: dense)."""
    from esme_tpu_torch import ESM2
    model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
    if quant:
        model.quantize(quant)
    return ft_model(dev, lift_b=True, model=model)


def lora_leaves(model):
    """The names of ``model``'s frozen and of its trained leaves under
    ``lora_only=True``."""
    from esme_tpu_torch.train.partition import expand_mask
    flags = expand_mask(model.trainable_filter(lora_only=True), model.params)
    names = [n for n, _ in _named_leaves(model.params)]
    trains = list(_leaves(flags))
    return ({n for n, f in zip(names, trains) if not f},
            {n for n, f in zip(names, trains) if f})


def _is_quant_leaf(name):
    from esme_tpu_torch.quant import NON_TRAINABLE_QUANT_LEAVES
    parts = name.split('.')
    return parts[-1] in NON_TRAINABLE_QUANT_LEAVES and len(parts) > 1 \
        and parts[-2] in QUANT_LINEARS


def host_copies(params, names):
    """Host copies of the leaves of ``params`` named in ``names``."""
    return {name: t.to('cpu', copy=True) for name, t in _named_leaves(params)
            if name in names}


def trainer_checks(plm, params, frozen, trained, what):
    """After a trainer's steps: no frozen view requires or holds a
    gradient; every leaf of ``frozen`` (host copies from before the steps)
    bit-unchanged in ``params`` (the tree the trainer updates: the model's
    params, or a sharded trainer's shards); every leaf of ``trained``
    (host copies) moved; the optimizer's state exactly the trained views'
    two Adam moments. Fails otherwise."""
    from esme_tpu_torch.train.trainer import _leaves as view_leaves
    views = list(view_leaves(plm._views))
    trained_views = getattr(plm, '_trained', None) or plm._params
    ids = {id(t) for t in trained_views}
    graded = sum(1 for t in views if id(t) not in ids
                 and (t.requires_grad or t.grad is not None))
    now = dict(_named_leaves(params))
    changed = [n for n, t in frozen.items()
               if not torch.equal(now[n].to('cpu'), t)]
    still = [n for n, t in trained.items()
             if torch.equal(now[n].to('cpu'), t)]
    opt = plm.optimizer
    state_bytes = sum(v.numel() * v.element_size()
                      for st in opt.state.values() for v in st.values()
                      if torch.is_tensor(v) and v.dim() > 0)
    moment_bytes = sum(2 * t.numel() * t.element_size()
                       for t in trained_views)
    quant = sum(1 for n in frozen if _is_quant_leaf(n))
    log(f'{what}: {len(frozen)} frozen leaves ({quant} quantized) '
        f'bit-unchanged: {not changed}; {len(trained)} trained leaves, '
        f'unmoved: {still}; frozen views with a gradient: {graded}; '
        f'optimizer state {state_bytes:,} bytes, the trained views\' '
        f'moments {moment_bytes:,}')
    if changed or still or graded or state_bytes != moment_bytes:
        fail(f'{what}: frozen leaves changed {changed}, trained leaves '
             f'unmoved {still}, frozen views with a gradient {graded}, '
             f'optimizer state {state_bytes} bytes against the moments\' '
             f'{moment_bytes}')
    return {'frozen_leaves': len(frozen), 'quantized_frozen_leaves': quant,
            'trained_leaves': len(trained), 'optimizer_bytes': state_bytes}


def check_lora_cells(model, mesh, card, what):
    """(a) or (b) on ``model``: one step's loss and adapters' gradients of
    ``ShardedMaskedPLM(lora_only=True, seq_axis='seq')`` against
    ``MaskedPLM(lora_only=True)``'s (loss within ``CP_LOSS_REL``, each
    adapter under phase 5's gates, the same leaves frozen, no quantized
    leaf with a gradient); then both trainers' cells (launches exact, ms
    a step, real tokens/s, peak), each followed by
    :func:`trainer_checks`."""
    import functools
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM
    key, budget, ckpt, _, _ = TRAIN_CELLS[0]
    L = model.config.num_layers
    n_params = sum(p.numel() for p in _leaves(model.params))
    batch, _ = train_batch(budget, model)
    frozen_names, trained_names = lora_leaves(model)

    class sharded:
        def __init__(self, m, learning_rate):
            self.plm = ShardedMaskedPLM(m, mesh, learning_rate=learning_rate,
                                        lora_only=True, seq_axis='seq')

        def training_step(self, batch):
            return self.plm.training_step([batch])
    loss_ref, g_ref = MaskedPLM(model, lora_only=True)._grad_step(batch)
    loss, g = sharded(model, 1e-4).plm._grad_step([batch])
    got, nf = _trained_only(g)
    ref, nf_ref = _trained_only(g_ref)
    names = [n for n, _ in _named_leaves(got)]
    if names != [n for n, _ in _named_leaves(ref)] or nf != nf_ref \
            or set(names) != trained_names:
        fail(f'{what}: the trained leaves differ: {names} against '
             f'{[n for n, _ in _named_leaves(ref)]} ({nf} and {nf_ref} '
             'frozen)')
    graded_quant = [n for n, t in _named_leaves(g)
                    if _is_quant_leaf(n) and t is not None]
    rel = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
    check = compare_grads(got, ref, GRAD_MIN_COS, GRAD_MAX_REL,
                          f'[{card}] {what}: adapters\' gradients, '
                          'ShardedMaskedPLM vs MaskedPLM')
    check.update(loss=loss.item(), loss_masked_plm=loss_ref.item(),
                 loss_rel=rel, frozen_leaves=nf)
    log(f'[{card}] {what}: loss {loss.item():.6f} vs MaskedPLM '
        f'{loss_ref.item():.6f} (relative {rel:.2e}, gate {CP_LOSS_REL}); '
        f'{len(names)} trained leaves, {nf} frozen; quantized leaves with a '
        f'gradient: {graded_quant}')
    if rel > CP_LOSS_REL or graded_quant:
        fail(f'{what}: loss {loss.item()} vs {loss_ref.item()}, quantized '
             f'leaves with a gradient {graded_quant}')
    del g, g_ref, got, ref
    torch.cuda.empty_cache()

    def after(params_of):
        def check_trainer(plm):
            plm = getattr(plm, 'plm', plm)
            return trainer_checks(plm, params_of(plm), frozen, trained,
                                  f'[{card}] {what} {type(plm).__name__}')
        return check_trainer
    frozen = host_copies(model.params, frozen_names)
    trained = host_copies(model.params, trained_names)
    out = {'grads': check}
    out['sharded'] = train_cell(
        model, sharded, f'lora_{key}', budget, ckpt, LORA_REPS, False,
        n_params, None, what=f'[{card}] {what} ShardedMaskedPLM: ',
        expected=expected_launches(**{H9_NAME: L, H10_NAME: L, H3_NAME: 2 * L,
                                      'rope_inverse': L}),
        after=after(lambda plm: plm.params))
    # MaskedPLM updates the model's adapters in place: last
    out['masked_plm'] = train_cell(
        model, functools.partial(MaskedPLM, lora_only=True), f'lora_{key}',
        budget, ckpt, LORA_REPS, False, n_params, None,
        what=f'[{card}] {what} MaskedPLM: ',
        after=after(lambda plm: plm.model.params))
    s, m = out['sharded'], out['masked_plm']
    log(f'[{card}] {what}: ShardedMaskedPLM {s["ms_per_step"]:.2f} ms a step '
        f'({s["real_tokens_per_s"]:.1f} real tokens/s, peak '
        f'{s["peak_mem_gib"]:.2f} GiB, optimizer {s["optimizer_bytes"]:,} '
        f'bytes); MaskedPLM {m["ms_per_step"]:.2f} ms '
        f'({m["real_tokens_per_s"]:.1f}, {m["peak_mem_gib"]:.2f} GiB, '
        f'{m["optimizer_bytes"]:,} bytes)')
    return out


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def check_resume(make, tree_of, step, card, what, cut=RESUME_CUT,
                 make_b=None, expected=None):
    """A resume through ``CheckpointManager`` (phase 17 (c), phase 19):
    trainer ``make()`` takes ``cut`` steps (``step(trainer)``), its state
    is saved in a temporary directory, and it takes one more; a fresh
    trainer ``make_b()`` (default ``make()``) restores the checkpoint and
    takes the same step. Gates: the resumed loss and every leaf of
    ``tree_of(trainer)`` (by path) bit-equal to the uninterrupted run's
    (by value for a leaf B holds in another dtype: NF4's outlier rows are
    fp32 from quantize-at-load, bf16 from ``quantize()``); with
    ``expected``, the resumed step's launches. Logs the checkpoint's
    bytes, save and restore seconds; ``reordered`` in the result: whether
    B's tree lists the same leaves in another order."""
    from esme_tpu_torch.train import CheckpointManager
    with tempfile.TemporaryDirectory() as tmp:
        ta = make()
        for _ in range(cut):
            step(ta)
        mgr = CheckpointManager(tmp, monitor=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(ta.step, ta.state)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(tmp)
        loss = step(ta)
        want = {n: t.clone() for n, t in _named_leaves(tree_of(ta))}
        del ta
        torch.cuda.empty_cache()
        tb = (make_b or make)()
        order = [n for n, _ in _named_leaves(tree_of(tb))]
        reordered = order != list(want) and set(order) == set(want)
        before = sum(n in want and not _same_values(t, want[n])
                     for n, t in _named_leaves(tree_of(tb)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb.state = mgr.restore(tb.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        reset_counters()
        got = step(tb)
        torch.cuda.synchronize()
        launches = read_counters()
        leaves = dict(_named_leaves(tree_of(tb)))
        differ = [n for n, t in leaves.items() if n not in want
                  or not _same_values(t, want[n])]
        missing = sorted(set(want) - set(leaves))
        cast = [n for n, t in leaves.items()
                if n in want and t.dtype != want[n].dtype]
        del tb, want, leaves
        torch.cuda.empty_cache()
    log(f'[{card}] {what} resume: checkpoint of {nbytes:,} bytes after '
        f'{cut} steps, saved in {save_s:.2f} s, restored in {restore_s:.2f} '
        f's into a trainer whose tree lists its {len(order)} leaves in '
        f'{"another" if reordered else "the same"} order ({before} of them '
        f'held other values before the restore); step {cut + 1} loss '
        f'{got!r} resumed vs {loss!r} uninterrupted; leaves that differ: '
        f'{differ[:8]} ({len(differ)}), missing {missing}; compared by value '
        f'in another dtype: {len(cast)} {cast[:2]}; launches {launches}')
    if got != loss or differ or missing:
        fail(f'{what}: the resumed step is not the uninterrupted one: loss '
             f'{got} vs {loss}, leaves {differ[:8]}, missing {missing}')
    if expected is not None and launches != expected:
        fail(f'{what}: launches {launches}, not {expected}')
    return {'bytes': nbytes, 'save_s': save_s, 'restore_s': restore_s,
            'loss': loss, 'launches': launches, 'leaves': len(order),
            'reordered': reordered, 'differed_before_restore': before,
            'compared_by_value': cast}


def check_phase17(dev, card):
    """Phase 17: (a) ESM2-650M with phase 14's adapters through
    ``ShardedMaskedPLM(lora_only=True, seq_axis='seq')`` in a one-rank NCCL
    world against ``MaskedPLM(lora_only=True)`` (:func:`check_lora_cells`);
    (b) the same over the trunk quantized to NF4 on the card; (c) resumes
    through ``CheckpointManager``: ``MaskedPLM`` with Adam, with
    ``offload_optimizer=True``, and (a)'s sharded trainer
    (:func:`check_resume`)."""
    import torch.distributed as dist
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM
    out, seconds = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        log(f'[{card}] phase 17 {key}: {seconds[key]:.1f} s')

    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0,
                           device=dev.type)
    try:
        mesh = make_mesh(1, 1, seq=1, device=dev.type)
        model = lora_model(dev)
        timed('a_lora', lambda: check_lora_cells(
            model, mesh, card, 'phase 17 (a) LoRA'))
        batch, _ = train_batch(TRAIN_CELLS[0][1], model)
        timed('c_sharded_resume', lambda: check_resume(
            lambda: ShardedMaskedPLM(model, mesh, learning_rate=1e-4,
                                     lora_only=True, seq_axis='seq'),
            lambda plm: plm.params, lambda plm: plm.training_step([batch]),
            card, 'phase 17 (c) ShardedMaskedPLM(lora_only=True)'))
        del model
        torch.cuda.empty_cache()
        model = lora_model(dev, '4bit')
        timed('b_qlora', lambda: check_lora_cells(
            model, mesh, card, 'phase 17 (b) LoRA over NF4'))
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    base = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)

    def dense(**kw):
        def make():
            model = ESM2(config=base.config, params=_clone(base.params),
                         device=dev)
            return MaskedPLM(model, learning_rate=1e-4, **kw)
        return make
    def step(plm):
        return plm.training_step(batch)
    timed('c_adam_resume', lambda: check_resume(
        dense(), lambda plm: plm.model.params, step, card,
        'phase 17 (c) MaskedPLM, Adam'))
    timed('c_offload_resume', lambda: check_resume(
        dense(offload_optimizer=True), lambda plm: plm.model.params, step,
        card, 'phase 17 (c) MaskedPLM(offload_optimizer=True)'))
    del base
    torch.cuda.empty_cache()
    out['seconds'] = seconds
    return out


# Phase 18: a sharded training state restored on a mesh of another shape
# (CheckpointManager.restore with a ShardedMaskedPLM state as template).
# Each cell of RESHARD_CELLS: (a) ESM2-650M trains on the card in a
# one-rank NCCL world on a (1, 1, 1) mesh through
# ShardedMaskedPLM(grad_accum=2, seq_axis='seq') for RESHARD_CUT
# micro-steps on phase 5's nockpt@10k batch (an update, then a cycle left
# open) and saves; (b) a gloo world of host ranks on the cell's mesh
# (another machine's ranks: processes that import only the port and run
# no forward) restores that checkpoint and saves it again; (c) the card
# restores (b)'s parts on (1, 1, 1) and takes the next micro-step.
RESHARD_CUT = 3
RESHARD_CELLS = (('dense', (2, 2, 1)), ('nf4_lora', (1, 2, 1)))
RESHARD_HOST_THREADS = 2
RESHARD_HOST_TIMEOUT = 600


def reshard_skeleton(kind):
    """ESM2 at ``MODEL`` on the host, bf16, with zero weights: a one-layer
    model's tree (for ``'nf4_lora'`` quantized to NF4, with phase 14's
    adapters) with each stacked leaf widened to ``MODEL``'s depth, so that
    every leaf has the model's shape and dtype without a 33-layer init
    on the host (a restore writes every leaf)."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.models.config import esm2_config
    one = ESM2(**{**MODEL, 'num_layers': 1}, dtype='bfloat16', rng=0,
               device='cpu')
    if kind == 'nf4_lora':
        one.quantize('4bit')
        one.add_lora(rank=FT_RANK, alpha=FT_RANK,
                     layers=('query', 'value', 'output'),
                     adapter_names=['ft'])
    depth = (MODEL['num_layers'],)

    def zeros(tree, stacked):
        return {k: zeros(v, stacked) if isinstance(v, dict) else torch.zeros(
            depth + v.shape[1:] if stacked else v.shape, dtype=v.dtype)
            for k, v in tree.items()}
    params = zeros({k: v for k, v in one.params.items() if k != 'layers'},
                   False)
    params['layers'] = zeros(one.params['layers'], True)
    model = ESM2(config=esm2_config(**MODEL, dtype='bfloat16'),
                 params=params, device='cpu')
    model.lora_kwargs = one.lora_kwargs
    return model


def reshard_trainer(kind, model, mesh):
    """The cell's trainer: ``ShardedMaskedPLM(grad_accum=2,
    seq_axis='seq')`` with Adam (``'dense'``) or over the adapters with
    ``adam8bit`` (``'nf4_lora'``)."""
    from esme_tpu_torch.train import ShardedMaskedPLM, adam8bit
    opts = dict(lora_only=True, optimizer=adam8bit(1e-4)) \
        if kind == 'nf4_lora' else {}
    return ShardedMaskedPLM(model, mesh, learning_rate=1e-4, grad_accum=2,
                            seq_axis='seq', **opts)


def reshard_host_rank(rank, n, port, kind, shape, src, dst, out):
    """Rank ``rank`` of (b)'s host world of ``n`` ranks on the ``(data,
    fsdp, seq)`` mesh ``shape``: the cell's trainer over
    :func:`reshard_skeleton` restores checkpoint directory ``src`` and
    saves its part to ``dst``; writes its seconds, its resident memory at
    its start and its peak (sampled every 10 ms) to
    ``out``/host_rank<r>.json."""
    import threading
    import torch.distributed as dist
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    from esme_tpu_torch.train import CheckpointManager
    torch.set_num_threads(RESHARD_HOST_THREADS)
    # the peak resident memory, sampled: the card's host has no VmHWM
    # in /proc, and getrusage's peak carries the parent's over the exec
    start = rss_gib()
    peak, stop = [start], threading.Event()

    def sample():
        while not stop.wait(0.01):
            peak[0] = max(peak[0], rss_gib())
    threading.Thread(target=sample, daemon=True).start()
    t0 = time.perf_counter()
    model = reshard_skeleton(kind)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        mesh = make_mesh(shape[0], shape[1], seq=shape[2], device='cpu')
        plm = reshard_trainer(kind, model, mesh)
        t1 = time.perf_counter()
        plm.state = CheckpointManager(src, monitor=None).restore(plm.state)
        t2 = time.perf_counter()
        CheckpointManager(dst, monitor=None).save(plm.step, plm.state)
        t3 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    stop.set()
    with open(os.path.join(out, f'host_rank{rank}.json'), 'w') as f:
        json.dump({'build_s': t1 - t0, 'restore_s': t2 - t1,
                   'save_s': t3 - t2, 'step': plm.step,
                   'start_rss_gib': start,
                   'peak_rss_gib': max(peak[0], rss_gib())}, f)


def reshard_host_world(kind, shape, src, dst, tmp, what):
    """(b): one spawned process per rank of ``shape`` running
    :func:`reshard_host_rank`; every process is joined or killed. Fails
    unless each exits 0. Returns the world's wall seconds and the
    ranks' largest seconds and peak resident memory."""
    import multiprocessing
    n = math.prod(shape)
    ctx = multiprocessing.get_context('spawn')
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=reshard_host_rank,
                         args=(r, n, port, kind, shape, src, dst, tmp))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RESHARD_HOST_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        fail(f'{what}: the host ranks exited with {codes}')
    ranks = []
    for r in range(n):
        with open(os.path.join(tmp, f'host_rank{r}.json')) as f:
            ranks.append(json.load(f))
    out = {'ranks': n, 'mesh': list(shape), 'wall_s': wall,
           'peak_rss_gib_sum': sum(r['peak_rss_gib'] for r in ranks),
           'steps': sorted({r['step'] for r in ranks})}
    out.update({key: max(r[key] for r in ranks) for key in (
        'build_s', 'restore_s', 'save_s', 'start_rss_gib', 'peak_rss_gib')})
    return out


def _same_bits(a, b) -> bool:
    b = b.to(a.device)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def state_differs(state, saved) -> list:
    """Where the sharded state ``state`` differs from the part ``saved``,
    bit for bit: params, the optimizer's tensors, scalars and groups, the
    step, the open cycle's gradients."""
    out = []
    a, b = dict(_named_leaves(state.params)), dict(_named_leaves(saved.params))
    out += [f'param {k}' for k in sorted(set(a) | set(b))
            if k not in a or k not in b or not _same_bits(a[k], b[k])]
    so, sb = state.opt_state, saved.opt_state
    if so['param_groups'] != sb['param_groups']:
        out.append('optimizer groups')
    if so['state'].keys() != sb['state'].keys():
        out.append('optimizer ids')
    for pid, st in so['state'].items():
        for key, v in st.items():
            w = sb['state'].get(pid, {}).get(key)
            same = _same_bits(v, w) if torch.is_tensor(v) and \
                torch.is_tensor(w) else v == w
            if not same:
                out.append(f'optimizer {pid} {key}')
    if state.step != saved.step:
        out.append('step')
    ga, gb = state.accum, saved.accum
    if ga is None or gb is None or len(ga) != len(gb):
        if not (ga is None and gb is None):
            out.append('accum')
    else:
        out += [f'accum {i}' for i, (x, y) in enumerate(zip(ga, gb))
                if (x is None) != (y is None)
                or (x is not None and not _same_bits(x, y))]
    return out


def part_bytes(step_dir, what):
    """The bytes of each part of a sharded checkpoint (by rank). Fails
    unless the parts at a ``data`` or ``seq`` coordinate other than 0 hold
    no param or optimizer tensor (their replica at ``data`` and ``seq`` 0
    writes them, as orbax writes each replicated shard once) and every
    other part holds both."""
    from esme_tpu_torch.train.checkpoint import _load
    sizes, wrong = {}, []
    for name in sorted(os.listdir(step_dir)):
        if not name.startswith('rank'):
            continue
        part = _load(os.path.join(step_dir, name), mmap=True)
        mesh = part.mesh
        replica = any(c for a, c in zip(mesh['axes'], mesh['coords'])
                      if a != 'fsdp')
        holds = part.params is not None or part.opt_state is not None
        if holds == replica or (not replica and part.opt_state is None):
            wrong.append((name, mesh['coords']))
        sizes[name] = {'bytes': os.path.getsize(os.path.join(step_dir, name)),
                       'coords': list(mesh['coords']), 'replica': replica}
        del part
    if wrong:
        fail(f'{what}: parts that hold params or optimizer state where they '
             f'should not, or lack them: {wrong}')
    return sizes


def reshard_cell(kind, model, mesh, host_shape, batch, card, tmp):
    """One cell of phase 18 ((a)-(c) above) in ``tmp``. Gates: the state
    restored in (c) bit-equal to (a)'s saved part (params, optimizer
    state, step, open cycle); the resumed micro-step's loss and every
    param bit-equal to the uninterrupted one's; its launches exact (H9 L,
    H10 L, H3 2L of which L inverse, H1 and H2 never); (b)'s parts at a
    ``data`` or ``seq`` coordinate other than 0 without param or optimizer
    tensors (:func:`part_bytes`). Logs the checkpoints' bytes (each of
    (b)'s parts too), the save and restore seconds on the card and on the
    host, and the host ranks' peak resident memory."""
    from esme_tpu_torch.train import CheckpointManager
    from esme_tpu_torch.train.checkpoint import _load
    what = f'[{card}] phase 18 {kind}'
    L = model.config.num_layers
    src, dst = os.path.join(tmp, 'a'), os.path.join(tmp, 'b')
    plm = reshard_trainer(kind, model, mesh)
    for _ in range(RESHARD_CUT):
        plm.training_step([batch])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(src, monitor=None).save(plm.step, plm.state)
    save_s = time.perf_counter() - t0
    loss = plm.training_step([batch])
    want = {n: t.clone() for n, t in _named_leaves(plm.params)}
    del plm
    torch.cuda.empty_cache()
    host = reshard_host_world(kind, host_shape, src, dst, tmp, what)
    log(f'{what} (b): {host["ranks"]} gloo ranks on the host on a '
        f'{tuple(host_shape)} mesh (another machine\'s ranks, no forward) '
        f'restored and saved again in {host["wall_s"]:.2f} s wall (build '
        f'{host["build_s"]:.2f} s, restore {host["restore_s"]:.2f} s, save '
        f'{host["save_s"]:.2f} s, the slowest rank of each); peak resident '
        f'memory {host["peak_rss_gib"]:.2f} GiB a rank (at its start, '
        f'the port imported: {host["start_rss_gib"]:.2f} GiB), '
        f'{host["peak_rss_gib_sum"]:.2f} GiB summed')
    if host['steps'] != [RESHARD_CUT]:
        fail(f'{what}: the host ranks restored steps {host["steps"]}')
    parts = part_bytes(os.path.join(dst, str(RESHARD_CUT)), f'{what} (b)')
    log(f'{what} (b): its parts\' bytes ' + ', '.join(
        f'{name} at {tuple(p["coords"])} {p["bytes"]:,}'
        + (' (replica)' if p['replica'] else '')
        for name, p in parts.items()))
    fresh = reshard_trainer(kind, model, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.state = CheckpointManager(dst, monitor=None).restore(fresh.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved = _load(os.path.join(src, str(RESHARD_CUT), 'rank0.pt'),
                  mmap=True)
    differ = state_differs(fresh.state, saved)
    del saved
    reset_counters()
    got = fresh.training_step([batch])
    torch.cuda.synchronize()
    launches = read_counters()
    leaves = [n for n, t in _named_leaves(fresh.params)
              if not _same_bits(t, want[n])]
    del fresh, want
    torch.cuda.empty_cache()
    sizes = {k: _dir_bytes(d) for k, d in (('a', src), ('b', dst))}
    log(f'{what}: (a) checkpoint of {sizes["a"]:,} bytes after '
        f'{RESHARD_CUT} micro-steps saved in {save_s:.2f} s on the card; '
        f'(b)\'s {sizes["b"]:,} bytes in {host["ranks"]} parts; (c) '
        f'restored on (1, 1, 1) in {restore_s:.2f} s; the state against '
        f'(a)\'s, places that differ: {differ[:8]} ({len(differ)}); '
        f'micro-step {RESHARD_CUT + 1} loss {got!r} resumed vs {loss!r} '
        f'uninterrupted; leaves that differ: {leaves[:8]} ({len(leaves)}); '
        f'launches {launches}')
    expect_launches(f'{what} (c)', launches, **{
        H9_NAME: L, H10_NAME: L, H3_NAME: 2 * L, 'rope_inverse': L})
    if differ or got != loss or leaves:
        fail(f'{what}: the round trip is not bit-equal: state {differ}, '
             f'loss {got} vs {loss}, leaves {leaves}')
    return {'bytes_a': sizes['a'], 'bytes_b': sizes['b'],
            'parts_b': parts,
            'save_s': save_s, 'restore_s': restore_s, 'host': host,
            'loss': loss, 'launches': launches}


def check_phase18(dev, card):
    """Phase 18: each cell of ``RESHARD_CELLS`` through
    :func:`reshard_cell`, in one one-rank NCCL world on a (1, 1, 1) mesh:
    ESM2-650M (seed-0 weights) trained fully under Adam, its host world
    on (2, 2, 1); the same with phase 14's adapters over the trunk
    quantized to NF4 on the card, ``lora_only`` under ``adam8bit``, its
    host world on (1, 2, 1)."""
    import torch.distributed as dist
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    out, seconds = {}, {}
    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0,
                           device=dev.type)
    try:
        mesh = make_mesh(1, 1, seq=1, device=dev.type)
        for kind, host_shape in RESHARD_CELLS:
            t0 = time.perf_counter()
            model = lora_model(dev, '4bit') if kind == 'nf4_lora' else \
                ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
            batch, _ = train_batch(TRAIN_CELLS[0][1], model)
            with tempfile.TemporaryDirectory() as tmp:
                out[kind] = reshard_cell(kind, model, mesh, host_shape,
                                         batch, card, tmp)
            del model
            torch.cuda.empty_cache()
            seconds[kind] = time.perf_counter() - t0
            log(f'[{card}] phase 18 {kind}: {seconds[kind]:.1f} s')
    finally:
        dist.destroy_process_group()
    out['seconds'] = seconds
    return out


# Phase 19: trainer states restored by leaf path. Each cell saves a
# trainer's state through CheckpointManager and restores it into a fresh
# trainer whose params tree lists the same leaves in another order; the
# resumed step is held bit-equal to the uninterrupted one. (a) MaskedPLM
# under Adam with grad_accum=2 on phase 5's nockpt@10k batch, cut after
# STATE_CUT micro-steps (an update, then a cycle left open); (b) phase
# 14's adapters over NF4 under adam8bit, lora_only, cut after RESUME_CUT
# steps; (c) RegressionTrainer with the aggregation head on phase 14's
# gb1_265 batch, cut after RESUME_CUT steps.
STATE_CUT = 3


def sorted_tree(tree, dev):
    """``tree``'s weights laid out as ``models/io.py:params_from_jax``
    gives them from JAX's pytree: every dict's keys sorted, each leaf
    through host numpy (a bf16 leaf as its raw 16-bit words, as that
    function carries it), without JAX."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            words = t.cpu().view(torch.int16).numpy().copy()
            return torch.from_numpy(words).view(torch.bfloat16).to(dev)
        return torch.from_numpy(t.cpu().numpy().copy()).to(dev)
    return {k: sorted_tree(tree[k], dev) if isinstance(tree[k], dict)
            else leaf(tree[k]) for k in sorted(tree)}


def reversed_tree(tree):
    """``tree``'s leaves (the same tensors) with every dict's keys in
    reverse order: ``k`` before ``q``, the head's ``final`` first."""
    return {k: reversed_tree(tree[k]) if isinstance(tree[k], dict)
            else tree[k] for k in reversed(list(tree))}


def _same_values(a, b) -> bool:
    """Bit-equal, or for leaves of two dtypes (NF4's outlier rows: fp32
    from quantize-at-load, bf16 from ``quantize()``) equal values."""
    if a.dtype == b.dtype:
        return _same_bits(a, b)
    return a.shape == b.shape and torch.equal(a.to(b.device, b.dtype), b)


def check_phase19(dev, card):
    """Phase 19: three cross-order resumes (:func:`check_resume`) at
    ESM2-650M's full width (bf16, seed-0 weights written to a safetensors
    file in a temporary directory): (a) ``MaskedPLM`` under Adam with
    ``grad_accum=2``, A over ``ESM.from_pretrained(file)``, B over the same
    weights in :func:`sorted_tree`'s order; (b) phase 14's adapters over
    NF4, ``lora_only`` under ``adam8bit``, A over ``from_pretrained(file,
    quantization='4bit')``, B over ``from_pretrained(file).quantize('4bit')``
    (another NF4 draw and leaf order: the restore replaces B's trunk);
    (c) ``RegressionTrainer`` with phase 14's adapters and aggregation
    head, B's model and head in :func:`reversed_tree`'s order. Launches of
    each resumed step: H1 33, H2 33, H3 66 of which 33 inverse."""
    import functools
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.models.config import esm2_config
    from esme_tpu_torch.train import MaskedPLM, RegressionTrainer, adam8bit
    out, seconds = {}, {}
    cfg = esm2_config(**MODEL, dtype='bfloat16')
    L = cfg.num_layers
    expected = expected_launches(**{H1_NAME: L, H2_NAME: L, H3_NAME: 2 * L,
                                    'rope_inverse': L})

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        log(f'[{card}] phase 19 {key}: {seconds[key]:.1f} s')

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'esm2_650m.safetensors')
        base = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
        base.save_pretrained(path)
        batch, _ = train_batch(TRAIN_CELLS[0][1], base)
        ft_batch = length_batch(base, FT_LENGTHS['gb1_265'])
        del base
        torch.cuda.empty_cache()

        def mlm_step(plm):
            return plm.training_step(batch)
        dense = functools.partial(MaskedPLM, learning_rate=1e-4,
                                  grad_accum=2)

        def sorted_model():
            fresh = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
            params = sorted_tree(fresh.params, dev)
            del fresh
            return ESM2(config=cfg, params=params, device=dev)
        timed('a_masked_plm', lambda: check_resume(
            lambda: dense(ESM2.from_pretrained(path, device=dev)),
            lambda t: t.model.params, mlm_step, card,
            'phase 19 (a) MaskedPLM, Adam, grad_accum=2, from_pretrained '
            "against params_from_jax's sorted order", cut=STATE_CUT,
            make_b=lambda: dense(sorted_model()), expected=expected))

        def qlora(model):
            return MaskedPLM(ft_model(dev, lift_b=True, model=model),
                             lora_only=True, optimizer=adam8bit(1e-4))
        timed('b_qlora', lambda: check_resume(
            lambda: qlora(ESM2.from_pretrained(path, quantization='4bit',
                                               device=dev)),
            lambda t: t.model.params, mlm_step, card,
            "phase 19 (b) QLoRA (NF4, adam8bit, lora_only), "
            "from_pretrained(quantization='4bit') against quantize('4bit')",
            make_b=lambda: qlora(ESM2.from_pretrained(path, device=dev)
                                 .quantize('4bit')), expected=expected))

        def regression(reorder, head_seed):
            model = ft_model(dev, lift_b=True)
            head = ft_head(dev, seed=head_seed)
            if reorder:
                model.params = reversed_tree(model.params)
                head = reversed_tree(head)
            return RegressionTrainer(model, head, head_lr=FT_HEAD_LR,
                                     lr=FT_LR,
                                     head_attention_heads=FT_HEAD_HEADS)
        timed('c_regression', lambda: check_resume(
            lambda: regression(False, 0),
            lambda t: {'plm': t.model.params, 'head': t.head_params},
            lambda t: t.training_step(ft_batch), card,
            'phase 19 (c) RegressionTrainer, aggregation head, gb1_265, '
            'every dict of the tree in reverse order',
            make_b=lambda: regression(True, 5), expected=expected))
    stale = [key for key, c in out.items() if not c['reordered']]
    if stale:
        fail(f'phase 19 {stale}: the resumed trainer lists its leaves in the '
             'saved order, or other leaves')
    out['seconds'] = seconds
    return out


# Phase 20 (``python3 chip_smoke.py --ranks N``): the mesh on N cards. The
# parent builds every kernel once, then spawns one process per card
# (``phase20_rank``); each joins a process group per cell (NCCL on its
# card, ``WORLD_TIMEOUT_S``) with the ranks 0..w-1 of that cell's world of
# w, and the parent stops every rank when one fails or the deadline
# passes. Cells, in order:
# (a) ESM2-650M (seed-0 weights) through context_parallel_log_prob on the
#     50k inference batch, seq = each of CP_WORLDS;
# (b) phase 11's ckpt@50k through ShardedMaskedPLM(seq_axis='seq') on
#     each of DENSE_MESHES against MaskedPLM on one card;
# (c) phase 17's adapters (dense, then NF4) on nockpt@10k through
#     ShardedMaskedPLM(lora_only=True, seq_axis='seq') on each of
#     LORA_MESHES against the single-device gradient of the global masked
#     mean (MaskedPLM(lora_only=True) on each data row's batch, weighted
#     by its masked tokens);
# (d) phase 18's dense state (Adam, grad_accum=2, cut after RESHARD_CUT
#     micro-steps) saved by the ranks of SAVE_MESH and restored there and
#     on one card, then a one-card state restored on RESTORE_MESH;
# (e) ESM2-15B trained fully over FSDP on BIG_MESH (remat='full', Adam):
#     BIG_CUT layers at full width against MaskedPLM on one card, then the
#     whole model at each of BIG_BUDGETS that fits.
RANK_CHOICES = (4,)
WORLD_TIMEOUT_S = 180
RANKS_DEADLINE_S = 900
RANK_THREADS = 2
RANK_PORTS = 24
CP_WORLDS = (1, 2, 4)
DENSE_MESHES = ((1, 1, 2), (1, 1, 4), (1, 2, 2), (1, 4, 1))
LORA_MESHES = ((1, 4, 1), (2, 2, 1))
# each mesh's steps: the first timed apart, the first CP_COMPARE_STEPS
# held to the one card's in (b)
DENSE_STEPS = LORA_STEPS = 5
SAVE_MESH, RESTORE_MESH = (2, 2, 1), (1, 4, 1)
BIG_SIZE = 'esm2_15b'
BIG_MESH = (1, 4, 1)
BIG_CUT = 2
# (budget, steps): the 50k cell runs where the 10k cell's memory, scaled,
# leaves BIG_MEM_SHARE of the card
BIG_BUDGETS = ((10_000, 5), (50_000, 3))
BIG_MEM_SHARE = 0.92
GATHER_REPS = 20


class _RssPeak:
    """This process's peak resident host memory since ``reset``, sampled
    every 10 ms by a daemon thread (the card's host has no VmHWM)."""

    def __init__(self):
        import threading
        self.peak = rss_gib()
        self._stop = threading.Event()
        threading.Thread(target=self._sample, daemon=True).start()

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_gib())

    def reset(self) -> float:
        self.peak = rss_gib()
        return self.peak

    def read(self) -> float:
        return max(self.peak, rss_gib())


class _Worlds:
    """One rank's process groups in phase 20: each cell's world takes the
    next port of ``ports`` on every rank, in the same order."""

    def __init__(self, rank, ports, dev):
        self.rank, self.dev, self._ports = rank, dev, iter(ports)

    @contextlib.contextmanager
    def world(self, size):
        """The world of ranks 0..size-1 (NCCL on the card, gloo on the
        CPU; ``WORLD_TIMEOUT_S`` for it and every group of its meshes),
        destroyed at the end; yields whether this rank is in it."""
        from datetime import timedelta
        import torch.distributed as dist
        from esme_tpu_torch.parallel import initialize_distributed
        port = next(self._ports)
        if self.rank >= size:
            yield False
            return
        initialize_distributed(f'127.0.0.1:{port}', size, self.rank,
                               device=self.dev.type,
                               timeout=timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            yield True
        finally:
            dist.destroy_process_group()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(x, y) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


NCCL_KINDS = ('AllGather', 'ReduceScatter', 'AllReduce')


def profile_collectives(run, out_dir, table, what):
    """One call of ``run`` under ``torch.profiler``: the device ms of the
    NCCL kernels by kind (all-gather, reduce-scatter, all-reduce, other)
    and their calls, the device ms of every other kernel and copy, how much
    of the NCCL kernels' time overlaps them, and the call's wall ms; with
    ``out_dir``, the table by kernel in ``out_dir/table``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if DEVICE == 'cuda' else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds = {k: {'ms': 0.0, 'calls': 0} for k in (*NCCL_KINDS, 'other')}
    nccl, compute = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.is_user_annotation:
            continue
        span = (e.time_range.start, e.time_range.end)
        if 'nccl' in e.name.lower():
            kind = next((k for k in NCCL_KINDS if k in e.name), 'other')
            kinds[kind]['ms'] += (span[1] - span[0]) / 1e3
            kinds[kind]['calls'] += 1
            nccl.append(span)
        else:
            compute.append(span)
    nccl, compute = _merge(nccl), _merge(compute)
    out = {'nccl': kinds,
           'nccl_busy_ms': sum(b - a for a, b in nccl) / 1e3,
           'compute_busy_ms': sum(b - a for a, b in compute) / 1e3,
           'overlap_ms': _overlap(nccl, compute) / 1e3, 'wall_ms': wall}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, table), 'w') as f:
            f.write(prof.key_averages().table(
                sort_by='self_device_time_total', row_limit=40))
    log(f'profiled {what}: NCCL kernels {kinds}; NCCL busy '
        f'{out["nccl_busy_ms"]:.2f} ms, the rest {out["compute_busy_ms"]:.2f}'
        f' ms, overlapping {out["overlap_ms"]:.2f} ms, wall {wall:.2f} ms'
        + (f'; table in {out_dir}/{table}' if out_dir else ''))
    return out


def gather_busbw(group, rows, width, dev):
    """One layer's k all-gather over ``group`` alone (``rows`` × ``width``
    bf16 a rank, ``parallel/context.py:_all_gather``), ``GATHER_REPS``
    calls after a warm-up, CUDA events: ms a gather and the bus bandwidth,
    (n-1)/n of the gathered bytes over that time (NCCL's busbw)."""
    import torch.distributed as dist
    from esme_tpu_torch.parallel.context import _all_gather
    n = dist.get_world_size(group)
    x = torch.randn(rows, width, device=dev).to(torch.bfloat16)
    _all_gather(x, group)
    dist.barrier(group=group)
    ms = cuda_ms(lambda: _all_gather(x, group), GATHER_REPS)
    nbytes = n * x.numel() * x.element_size()
    return {'ms': ms, 'bytes': nbytes, 'ranks': n,
            'busbw_gb_s': (n - 1) / n * nbytes / (ms * 1e-3) / 1e9}


def same_weights(params, what):
    """Every rank of the world holds the same weights: each leaf's sum and
    sum of squares in float64, gathered and held equal; fails otherwise."""
    import torch.distributed as dist
    d = torch.stack([torch.stack([t.double().sum(), t.double().square()
                                  .sum()]) for t in _leaves(params)])
    got = [torch.empty_like(d) for _ in range(dist.get_world_size())]
    dist.all_gather(got, d)
    if not all(torch.equal(g, d) for g in got):
        fail(f'{what}: the ranks\' weights differ')


def reference_steps(model, make, batches, steps, what, keep_after=True):
    """``make(copy of model)`` on this card (the copy's params and
    ``lora_kwargs``): ``steps`` steps on ``batches`` (a PackedBatch, or a
    list of them, one a step in turn), the first timed apart. Returns its
    cell (losses, ms a step, peak) and, with ``keep_after``, the params
    after the first update (on the card)."""
    m = type(model)(config=model.config, params=_clone(model.params),
                    checkpointing=model.checkpointing, device=model.device)
    m.lora_kwargs = model.lora_kwargs
    plm = make(m)
    seq = batches if isinstance(batches, list) else [batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, samples, after, first = [], [], None, 0.0
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(plm.training_step(seq[i % len(seq)]))
        ms = (time.perf_counter() - t0) * 1e3
        if i == 0:
            first = ms
            after = _clone(m.params) if keep_after else None
        else:
            samples.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del plm, m
    torch.cuda.empty_cache()
    cell = {'losses': losses, 'first_step_ms': first,
            'ms_per_step': float(np.median(samples)) if samples else None,
            'ms_per_step_samples': samples, 'peak_mem_gib': peak}
    log(f'{what}: losses {losses}, first step {first:.2f} ms, then '
        f'{[round(x, 2) for x in samples]} ms, peak {peak:.2f} GiB')
    return cell, after


def mesh_steps(plm, batches, steps, expected, what, keep_after=False):
    """``steps`` training steps of the sharded trainer ``plm`` on
    ``batches`` (its data rows' batches), the launch counters set to 0
    just before the first and read just after it (fails unless they are
    ``expected``), the first timed apart (NCCL makes a group's
    communicator at its first collective), the rest on the host clock
    from a barrier of the world to the end of a step (``float(loss)``).
    Returns the cell and, with ``keep_after``, the params gathered after
    the first update (host)."""
    import torch.distributed as dist
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses = [plm.training_step(batches)]
    first = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    if launches != expected:
        fail(f'{what}: launches {launches}, not {expected}')
    after = plm.unsharded_params() if keep_after else None
    samples = []
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        # every rank starts the step together, so that a rank's time is
        # the world's step and not its offset from the slowest rank's
        dist.barrier()
        t0 = time.perf_counter()
        losses.append(plm.training_step(batches))
        samples.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        fail(f'{what}: losses not finite: {losses}')
    cell = {'losses': losses, 'launches': launches, 'first_step_ms': first,
            'ms_per_step': float(np.median(samples)),
            'ms_per_step_samples': samples, 'peak_mem_gib': peak}
    log(f'{what}: launches {launches}; losses {losses}; first step '
        f'{first:.2f} ms, then {[round(x, 2) for x in samples]} ms; peak '
        f'{peak:.2f} GiB')
    return cell, after


def hold_to_reference(cell, after, ref, ref_after, before, lr, what):
    """Phase 11's gates on rank 0: each of the reference's steps' loss
    within ``CP_LOSS_REL`` of the one-card reference's, the params after
    the first update under :func:`compare_updates`. Returns the comparison
    (and whether the losses and params were bit-equal)."""
    n = len(ref['losses'])
    got = cell['losses'][:n]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref['losses'])]
    check = compare_updates(after, ref_after, before, lr, what)
    check.update(loss_rel=rel, losses_equal=got == ref['losses'])
    log(f'{what}: losses {got} vs {ref["losses"]} (relative '
        f'{[f"{x:.2e}" for x in rel]}, gate {CP_LOSS_REL}); after the first '
        f'update {check["bit_equal"]} of {check["leaves"]} leaves bit-equal, '
        f'max |delta| {check["max_abs"]:.3e}, the updates\' difference at '
        f'most {check["max_mass_ratio"]:.3e} of the update')
    if max(rel) > CP_LOSS_REL:
        fail(f'{what}: a step\'s loss differs by more than {CP_LOSS_REL}')
    return check


def cp_cells20(worlds, dev, profile_dir):
    """(a): ESM2-650M (seed-0 weights, built on every card) through
    ``context_parallel_log_prob`` on the 50k inference batch on ``seq`` =
    each of ``CP_WORLDS`` (the ranks 0..w-1): the weights the same on
    every rank, launches exact on every rank (H9 and H3 once a layer, H1
    never), each rank's (T, V) log-probs finite normalised rows under
    phase 4's gate against this card's ``predict_log_prob`` (bit equality
    logged); ms a forward (CUDA events after a warm-up), real tokens/s,
    peak memory; one k gather alone (its ms and bus bandwidth); on rank 0
    one forward profiled (the NCCL kernels' device time)."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import context_parallel_log_prob, make_mesh
    model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
    L = model.config.num_layers
    tokens, cu, max_len = packed_batch(BUDGET, seed=0)
    real = int(cu[-1])
    ref = model.predict_log_prob(tokens, pad_args=(cu, max_len))[:real] \
        .clone()
    out = {}
    for w in CP_WORLDS:
        with worlds.world(w) as inside:
            if not inside:
                continue
            what = f'phase 20 (a) context parallel, seq={w}'
            mesh = make_mesh(seq=w, device=dev.type)
            same_weights(model.params, what)

            def run():
                return context_parallel_log_prob(model, tokens,
                                                 (cu, max_len), mesh)
            reset_counters()
            lp = run()
            torch.cuda.synchronize()
            launches = read_counters()
            expect_launches(what, launches, **{H9_NAME: L, H3_NAME: L})
            lse_err = lp[:real].logsumexp(-1).abs().max().item()
            if tuple(lp.shape) != (len(tokens), model.config.vocab_size) \
                    or not bool(torch.isfinite(lp).all()) \
                    or lse_err > LOGSUMEXP_ATOL:
                fail(f'{what}: log-probs of {tuple(lp.shape)} are not '
                     f'finite normalised rows (max|logsumexp| {lse_err})')
            check = compare_logp(lp[:real], ref, f'{what}: the rank\'s '
                                 '(T, V) vs predict_log_prob on its card')
            check['bit_equal'] = bool(torch.equal(lp[:real], ref))
            log(f'{what}: bit-equal to predict_log_prob '
                f'{check["bit_equal"]}')
            del lp
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            samples = [cuda_ms(run, reps=1, warmup=int(i == 0))
                       for i in range(FWD_REPS)]
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms = float(np.median(samples))
            cell = {'launches': launches, 'vs_predict_log_prob': check,
                    'ms_per_batch': ms, 'ms_per_batch_samples': samples,
                    'real_tokens_per_s': real / ms * 1e3,
                    'real_tokens_per_s_per_card': real / ms * 1e3 / w,
                    'peak_mem_gib': peak}
            if w > 1:
                cell['k_gather'] = gather_busbw(
                    mesh.get_group('seq'), len(tokens) // w,
                    MODEL['embed_dim'], dev)
            if worlds.rank == 0:
                cell['profile'] = profile_collectives(
                    run, profile_dir, f'profile_p20_cp{w}.txt', what)
            else:
                run()
            log(f'{what}: median {ms:.2f} ms a forward of {FWD_REPS}, '
                f'{real / ms * 1e3:.1f} real tokens/s ({real / ms * 1e3 / w:.1f}'
                f' a card), peak {peak:.2f} GiB; k gather '
                f'{cell.get("k_gather")}')
            out[str(w)] = cell
    del model, ref
    torch.cuda.empty_cache()
    return out


def dense_cells20(worlds, dev, profile_dir):
    """(b): phase 11's ``ckpt@50k`` (ESM2-650M, seed-0 weights,
    checkpointing, ``remat='full'``, Adam at 1e-4) through
    ``ShardedMaskedPLM(seq_axis='seq')`` on each of ``DENSE_MESHES``, each
    from the same weights for ``DENSE_STEPS`` steps: launches exact on
    every rank (H9 66, H10 33, H3 99 of which 33 inverse, H1 and H2
    never), losses finite; on rank 0 the first ``CP_COMPARE_STEPS``
    against ``MaskedPLM`` on its card (:func:`hold_to_reference`); ms a
    step, real tokens/s, MFU, peak on
    every card; one more step profiled on rank 0 (the NCCL kernels'
    device time and overlap)."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import make_mesh
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM
    lr = 1e-4
    _, budget, ckpt, _, _ = TRAIN_CELLS[1]
    model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev,
                 checkpointing=ckpt)
    L = model.config.num_layers
    n_params = sum(p.numel() for p in _leaves(model.params))
    batch, attn = train_batch(budget, model)
    real = int(batch.cu_lens[-1])
    flops = 6 * n_params * real + 3.5 * attn
    out = {}
    ref = ref_after = None
    if worlds.rank == 0:
        ref, ref_after = reference_steps(
            model, lambda m: MaskedPLM(m, learning_rate=lr), batch,
            CP_COMPARE_STEPS, 'phase 20 (b) MaskedPLM on one card')
        ref['real_tokens_per_s'] = real / ref['ms_per_step'] * 1e3
        ref['mfu'] = flops / (ref['ms_per_step'] * 1e-3) / MFU_PEAK
        out['one_card'] = ref
    expected = expected_launches(**{H9_NAME: 2 * L, H10_NAME: L,
                                    H3_NAME: 3 * L, 'rope_inverse': L})
    for shape in DENSE_MESHES:
        w = math.prod(shape)
        with worlds.world(w) as inside:
            if not inside:
                continue
            what = f'phase 20 (b) ShardedMaskedPLM on {shape}'
            mesh = make_mesh(shape[0], shape[1], seq=shape[2],
                             device=dev.type)
            plm = ShardedMaskedPLM(model, mesh, learning_rate=lr,
                                   seq_axis='seq')
            batches = [batch] * shape[0]
            cell, after = mesh_steps(plm, batches, DENSE_STEPS, expected,
                                     what, keep_after=True)
            ms = cell['ms_per_step']
            cell.update(real_tokens_per_s=real * shape[0] / ms * 1e3,
                        real_tokens_per_s_per_card=real * shape[0] / ms
                        * 1e3 / w,
                        mfu=flops * shape[0] / (ms * 1e-3) / (MFU_PEAK * w))
            if worlds.rank == 0:
                cell['vs_masked_plm'] = hold_to_reference(
                    cell, after, ref, ref_after, model.params, lr,
                    f'{what} vs MaskedPLM')
                cell['profile'] = profile_collectives(
                    lambda: plm.training_step(batches), profile_dir,
                    f'profile_p20_train_{"x".join(map(str, shape))}.txt',
                    f'{what}: a step')
            else:
                plm.training_step(batches)
            del plm, after
            torch.cuda.empty_cache()
            out['x'.join(map(str, shape))] = cell
    del model, ref_after
    torch.cuda.empty_cache()
    return out


def lora_cells20(worlds, dev):
    """(c): phase 17's adapters (rank 16 on query, value, output, every
    ``b`` lifted) over ESM2-650M, dense and then NF4, on ``nockpt@10k``
    through ``ShardedMaskedPLM(lora_only=True, seq_axis='seq')`` on each
    of ``LORA_MESHES`` (data row r takes batch r: bench.py's recipe, then
    seeds 3 and 4): one step's loss and adapters' gradients on rank 0
    against the single-device gradient of the global masked mean
    (``MaskedPLM(lora_only=True)._grad_step`` on each row's batch, weighted
    by its masked tokens) under phase 17's gates, the same leaves trained;
    then ``LORA_STEPS`` steps (launches exact on every rank: H9 33, H10 33,
    H3 66 of which 33 inverse) and :func:`trainer_checks` on every rank;
    ``MaskedPLM(lora_only=True)``'s steps on rank 0's card beside them."""
    from esme_tpu_torch.parallel import make_mesh
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM
    lr = 1e-4
    _, budget, _, _, _ = TRAIN_CELLS[0]
    out = {}
    for trunk, quant in (('dense', None), ('nf4', '4bit')):
        model = lora_model(dev, quant)
        L = model.config.num_layers
        batches = edge_padded([train_batch(budget, model)[0],
                               train_batch(budget, model, seeds=(3, 4))[0]])
        real = [int(b.cu_lens[-1]) for b in batches]
        frozen_names, trained_names = lora_leaves(model)
        frozen = host_copies(model.params, frozen_names)
        trained = host_copies(model.params, trained_names)
        refs = None
        if worlds.rank == 0:
            plm = MaskedPLM(model, lora_only=True)
            refs = [(plm._grad_step(b), float(b.mask.sum())) for b in batches]
            del plm
            out[f'{trunk}_one_card'], _ = reference_steps(
                model, lambda m: MaskedPLM(m, learning_rate=lr,
                                           lora_only=True),
                batches[0], LORA_STEPS, f'phase 20 (c) {trunk} MaskedPLM('
                'lora_only=True) on one card', keep_after=False)
        expected = expected_launches(**{H9_NAME: L, H10_NAME: L,
                                        H3_NAME: 2 * L, 'rope_inverse': L})
        for shape in LORA_MESHES:
            w = math.prod(shape)
            with worlds.world(w) as inside:
                if not inside:
                    continue
                what = f'phase 20 (c) {trunk} LoRA on {shape}'
                mesh = make_mesh(shape[0], shape[1], seq=shape[2],
                                 device=dev.type)
                plm = ShardedMaskedPLM(model, mesh, learning_rate=lr,
                                       lora_only=True, seq_axis='seq')
                rows = batches[:shape[0]]
                loss, g = plm._grad_step(rows)
                cell = {}
                if worlds.rank == 0:
                    cell['grads'] = union_check(loss, g, refs[:shape[0]],
                                                trained_names, what)
                del g
                step, _ = mesh_steps(plm, rows, LORA_STEPS, expected, what)
                cell.update(step)
                ms = cell['ms_per_step']
                tok = sum(real[:shape[0]])
                cell.update(real_tokens_per_s=tok / ms * 1e3,
                            real_tokens_per_s_per_card=tok / ms * 1e3 / w)
                cell.update(trainer_checks(plm, plm.unsharded_params(),
                                           frozen, trained, what))
                del plm
                torch.cuda.empty_cache()
                out[f'{trunk} {"x".join(map(str, shape))}'] = cell
        del model, refs
        torch.cuda.empty_cache()
    return out


def edge_padded(batches):
    """The batches with their ``cu_lens`` padded to one length by
    repeating the last offset (empty segments), as the data plane pads
    them to a static shape, so that they stack into a mesh's data rows."""
    n = max(len(b.cu_lens) for b in batches)
    return [SimpleNamespace(**{**vars(b), 'cu_lens': np.pad(
        b.cu_lens, (0, n - len(b.cu_lens)), mode='edge')}) for b in batches]


def union_check(loss, grads, refs, trained_names, what):
    """The sharded step's loss and trained leaves' gradients against the
    single-device gradient of the global masked mean over the rows'
    batches, made from each batch's (``refs``: ``((loss, grads),
    masked tokens)``) as their masked-token-weighted mean; phase 17's gates
    (loss within ``CP_LOSS_REL``, each trained leaf under phase 5's), the
    same leaves trained."""
    from esme_tpu_torch.parallel.fsdp import _map
    total = sum(c for _, c in refs)
    ref_loss = sum(c * l.item() for (l, _), c in refs) / total
    got, nf = _trained_only(grads)
    mean = None
    for (_, g), c in refs:
        part, nf_ref = _trained_only(g)
        part = _map(lambda t: t.float() * (c / total), part)
        mean = part if mean is None else _map(
            lambda a, b: a + b, mean, part)
    names = [n for n, _ in _named_leaves(got)]
    if set(names) != trained_names or nf != nf_ref:
        fail(f'{what}: the trained leaves differ: {names} ({nf} frozen) '
             f'against {sorted(trained_names)} ({nf_ref})')
    rel = abs(loss.item() - ref_loss) / abs(ref_loss)
    check = compare_grads(_map(lambda t: t.float(), got), mean,
                          GRAD_MIN_COS, GRAD_MAX_REL,
                          f'{what}: adapters\' gradients vs the single-'
                          'device gradient of the global masked mean')
    check.update(loss=loss.item(), loss_reference=ref_loss, loss_rel=rel)
    log(f'{what}: loss {loss.item():.6f} vs {ref_loss:.6f} (relative '
        f'{rel:.2e}, gate {CP_LOSS_REL})')
    if rel > CP_LOSS_REL:
        fail(f'{what}: loss {loss.item()} vs {ref_loss}')
    return check


@contextlib.contextmanager
def timed_writes(seconds):
    """Append each ``torch.save``'s seconds to ``seconds`` (a
    checkpoint's part is one ``torch.save`` of its rank)."""
    save = torch.save

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
    torch.save = timed
    try:
        yield seconds
    finally:
        torch.save = save


def _holder_filled(step_dir, rank):
    """Rank ``rank``'s saved part, a replica's params and optimizer state
    taken from its holder's part (as ``CheckpointManager.restore`` fills
    them)."""
    from esme_tpu_torch.train.checkpoint import _holder, _load
    from pathlib import Path
    part = _load(os.path.join(step_dir, f'rank{rank}.pt'), mmap=True)
    if part.params is None:
        held = _holder(Path(step_dir), part.mesh)
        part = part._replace(params=held.params, opt_state=held.opt_state)
    return part


def _differing(got, want):
    """The leaf paths where the trees ``got`` and ``want`` differ in
    bits."""
    want = dict(_named_leaves(want))
    return [n for n, t in _named_leaves(got) if not _same_bits(t, want[n])]


def ckpt_cells20(worlds, dev, tmp, rss):
    """(d): phase 18's dense trainer (ESM2-650M, seed-0 weights, Adam,
    ``grad_accum=2``, ``seq_axis='seq'``) on phase 5's ``nockpt@10k`` batch
    (every data row the same batch, so that the mesh's step is the one
    card's), cut after ``RESHARD_CUT`` micro-steps: (i) the ranks of
    ``SAVE_MESH`` save their parts (each rank's write seconds, the world's
    wall seconds), take the uninterrupted micro-step, and fresh trainers
    there restore the parts and take it again: the state bit-equal to the
    saved part, the loss and every param bit-equal, launches exact (H9 33,
    H10 33, H3 66 of which 33 inverse); a replica's part without param or
    optimizer tensors (:func:`part_bytes`); (ii) one card (a one-rank
    world) restores them: its params bit-equal to the saved step's, its
    micro-step against (i)'s under phase 11's gates (bit equality logged);
    (iii) one card trains a state of its own from the same weights and
    saves it, and (iv) the ranks of ``RESTORE_MESH`` restore it: their
    params bit-equal to the saved step's, their micro-step against the one
    card's under phase 11's gates. Each rank's peak resident memory."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.parallel import make_mesh
    from esme_tpu_torch.train import CheckpointManager
    lr = 1e-4
    rank = worlds.rank
    model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
    L = model.config.num_layers
    batch, _ = train_batch(TRAIN_CELLS[0][1], model)
    dir_a, dir_b = os.path.join(tmp, 'ckpt_a'), os.path.join(tmp, 'ckpt_b')
    rss.reset()
    out = {}
    mine = {}           # rank 0's host copies for (ii) and (iv)

    def save(plm, path, what):
        writes = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_writes(writes):
            CheckpointManager(path, monitor=None).save(plm.step, plm.state)
        wall = time.perf_counter() - t0
        log(f'{what}: saved in {wall:.2f} s (this rank wrote its part in '
            f'{writes[0]:.2f} s)')
        return {'write_s': writes[0], 'save_s': wall}

    def restore(plm, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plm.state = CheckpointManager(path, monitor=None).restore(plm.state)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def resumed_step(plm, rows, what):
        reset_counters()
        loss = plm.training_step(rows)
        torch.cuda.synchronize()
        expect_launches(what, read_counters(), **{
            H9_NAME: L, H10_NAME: L, H3_NAME: 2 * L, 'rope_inverse': L})
        return loss

    # (i) the mesh saves, resumes on itself
    w = math.prod(SAVE_MESH)
    with worlds.world(w) as inside:
        if inside:
            what = f'phase 20 (d) (i) {SAVE_MESH}'
            mesh = make_mesh(SAVE_MESH[0], SAVE_MESH[1], seq=SAVE_MESH[2],
                             device=dev.type)
            rows = [batch] * SAVE_MESH[0]
            plm = reshard_trainer('dense', model, mesh)
            for _ in range(RESHARD_CUT):
                plm.training_step(rows)
            cell = save(plm, dir_a, what)
            mine['saved'] = plm.unsharded_params()
            loss = plm.training_step(rows)
            want = plm.unsharded_params()
            del plm
            torch.cuda.empty_cache()
            fresh = reshard_trainer('dense', model, mesh)
            cell['restore_s'] = restore(fresh, dir_a)
            step_dir = os.path.join(dir_a, str(RESHARD_CUT))
            differ = state_differs(fresh.state, _holder_filled(step_dir, rank))
            got = resumed_step(fresh, rows, what)
            leaves = _differing(fresh.unsharded_params(), want)
            log(f'{what}: restored state against the saved part, places '
                f'that differ {differ[:8]} ({len(differ)}); micro-step '
                f'{RESHARD_CUT + 1} loss {got!r} resumed vs {loss!r}; leaves '
                f'that differ {leaves[:8]} ({len(leaves)})')
            if differ or got != loss or leaves:
                fail(f'{what}: the resumed micro-step is not the '
                     f'uninterrupted one: state {differ[:8]}, loss {got} vs '
                     f'{loss}, leaves {leaves[:8]}')
            del fresh
            torch.cuda.empty_cache()
            cell['loss'] = loss
            if rank == 0:
                cell['parts'] = part_bytes(step_dir, what)
                mine['loss'], mine['after'] = loss, want
            out['i_save'] = cell
    # (ii) one card takes the mesh's parts; (iii) one card saves its own
    with worlds.world(1) as inside:
        if inside:
            what = f'phase 20 (d) (ii) {SAVE_MESH} -> (1, 1, 1)'
            mesh = make_mesh(1, 1, seq=1, device=dev.type)
            one = reshard_trainer('dense', model, mesh)
            cell = {'restore_s': restore(one, dir_a)}
            differ = _differing(one.params, mine['saved'])
            if differ or one.step != RESHARD_CUT:
                fail(f'{what}: restored params differ from the saved '
                     f'step\'s: {differ[:8]}, step {one.step}')
            cell['loss'] = resumed_step(one, [batch], what)
            after = one.unsharded_params()
            check = hold_to_reference(
                {'losses': [cell['loss']]}, after,
                {'losses': [mine['loss']]}, mine['after'], mine['saved'], lr,
                f'{what}: the micro-step on one card vs on the mesh')
            check['params_bit_equal'] = not _differing(after, mine['after'])
            cell['vs_mesh'] = check
            del one, after
            out['ii_restore_one_card'] = cell
            what = 'phase 20 (d) (iii) (1, 1, 1)'
            plm = reshard_trainer('dense', model, mesh)
            for _ in range(RESHARD_CUT):
                plm.training_step([batch])
            cell = save(plm, dir_b, what)
            cell['bytes'] = _dir_bytes(dir_b)
            mine['saved'] = plm.unsharded_params()
            mine['loss'] = plm.training_step([batch])
            mine['after'] = plm.unsharded_params()
            del plm
            torch.cuda.empty_cache()
            out['iii_save_one_card'] = cell
    # (iv) the mesh takes one card's state
    w = math.prod(RESTORE_MESH)
    with worlds.world(w) as inside:
        if inside:
            what = f'phase 20 (d) (iv) (1, 1, 1) -> {RESTORE_MESH}'
            mesh = make_mesh(RESTORE_MESH[0], RESTORE_MESH[1],
                             seq=RESTORE_MESH[2], device=dev.type)
            plm = reshard_trainer('dense', model, mesh)
            cell = {'restore_s': restore(plm, dir_b)}
            restored = plm.unsharded_params()
            loss = resumed_step(plm, [batch] * RESTORE_MESH[0], what)
            after = plm.unsharded_params()
            if rank == 0:
                differ = _differing(restored, mine['saved'])
                if differ or plm.step != RESHARD_CUT + 1:
                    fail(f'{what}: restored params differ from the saved '
                         f'step\'s: {differ[:8]}')
                check = hold_to_reference(
                    {'losses': [loss]}, after, {'losses': [mine['loss']]},
                    mine['after'], mine['saved'], lr,
                    f'{what}: the micro-step on the mesh vs on one card')
                check['params_bit_equal'] = not _differing(after,
                                                           mine['after'])
                cell['vs_one_card'] = check
            cell['loss'] = loss
            del plm, restored, after
            torch.cuda.empty_cache()
            out['iv_restore_mesh'] = cell
    out['peak_rss_gib'] = rss.read()
    del model, mine
    torch.cuda.empty_cache()
    if rank == 0:          # every rank is past (iv)
        import shutil
        for path in (dir_a, dir_b):
            shutil.rmtree(path, ignore_errors=True)
    return out


def big_cells20(worlds, dev, rss, profile_dir):
    """(e): ESM2-15B (``BIG_SIZE``: 48 layers, width 5120, 40 heads, D =
    128, bf16, seed-0 weights built on every card) over FSDP on
    ``BIG_MESH`` (``checkpointing=True``, ``remat='full'``, Adam at
    1e-4): first ``BIG_CUT`` layers at full width against ``MaskedPLM`` on
    rank 0's card under phase 11's gates; then the whole model, each rank
    dropping its full copy once the trainer holds its shards, at each of
    ``BIG_BUDGETS``' budgets (the 50k one where the 10k cell's peak,
    scaled, leaves ``BIG_MEM_SHARE`` of every card): launches exact on
    every rank (H9 96, H10 48, H3 144 of which 48 inverse), losses finite
    and falling by the run's end (its last below its largest), ms a step,
    real tokens/s, MFU, peak on every card, host memory of every rank."""
    import torch.distributed as dist
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.models.config import ESM2_SIZES
    from esme_tpu_torch.parallel import make_mesh
    from esme_tpu_torch.train import MaskedPLM, ShardedMaskedPLM
    lr = 1e-4
    cfg = dict(ESM2_SIZES[BIG_SIZE])
    w = math.prod(BIG_MESH)
    out = {}

    def mesh_of():
        return make_mesh(BIG_MESH[0], BIG_MESH[1], seq=BIG_MESH[2],
                         device=dev.type)

    def launches(L):
        return expected_launches(**{H9_NAME: 2 * L, H10_NAME: L,
                                    H3_NAME: 3 * L, 'rope_inverse': L})
    cut = ESM2(**{**cfg, 'num_layers': BIG_CUT}, dtype='bfloat16', rng=0,
               device=dev, checkpointing=True)
    budget = BIG_BUDGETS[0][0]
    batch, _ = train_batch(budget, cut)
    ref = ref_after = None
    if worlds.rank == 0:
        ref, ref_after = reference_steps(
            cut, lambda m: MaskedPLM(m, learning_rate=lr), batch,
            CP_COMPARE_STEPS, f'phase 20 (e) {BIG_SIZE} cut to {BIG_CUT} '
            'layers, MaskedPLM on one card')
        out['cut_one_card'] = ref
    with worlds.world(w) as inside:
        if inside:
            what = f'phase 20 (e) {BIG_SIZE} cut to {BIG_CUT} layers on ' \
                   f'{BIG_MESH}'
            plm = ShardedMaskedPLM(cut, mesh_of(), learning_rate=lr,
                                   seq_axis='seq')
            cell, after = mesh_steps(plm, [batch] * BIG_MESH[0],
                                     CP_COMPARE_STEPS, launches(BIG_CUT),
                                     what, keep_after=True)
            if worlds.rank == 0:
                cell['vs_masked_plm'] = hold_to_reference(
                    cell, after, ref, ref_after, cut.params, lr,
                    f'{what} vs MaskedPLM')
            out['cut'] = cell
            del plm, after
    del cut, ref_after
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ESM2(**cfg, dtype='bfloat16', rng=0, device=dev,
                 checkpointing=True)
    torch.cuda.synchronize()
    L = model.config.num_layers
    n_params = sum(p.numel() for p in _leaves(model.params))
    out['init'] = {'s': time.perf_counter() - t0, 'params': n_params,
                   'peak_mem_gib': torch.cuda.max_memory_allocated() / 2**30}
    log(f'phase 20 (e) {BIG_SIZE} {cfg} init on the card: '
        f'{out["init"]["s"]:.1f} s, {n_params:,} params, peak '
        f'{out["init"]["peak_mem_gib"]:.2f} GiB')
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    with worlds.world(w) as inside:
        if inside:
            plm = ShardedMaskedPLM(model, mesh_of(), learning_rate=lr,
                                   seq_axis='seq')
            # the caller's full copy goes once the trainer holds its shards
            model.params = None
            torch.cuda.empty_cache()
            shard_bytes = sum(t.numel() * t.element_size()
                              for t in _leaves(plm.params))
            out['shard_bytes'] = shard_bytes
            losses = []
            rss.reset()
            for budget, steps in BIG_BUDGETS:
                what = f'phase 20 (e) {BIG_SIZE} on {BIG_MESH} at {budget}'
                if losses:
                    # the 10k cell's activations scaled to this budget,
                    # beside the shards, their gradients and moments
                    prev = out[str(BIG_BUDGETS[0][0])]
                    resident = 4 * shard_bytes
                    act = prev['peak_mem_gib'] * 2**30 - resident
                    pred = torch.tensor(
                        [resident + act * budget / BIG_BUDGETS[0][0]],
                        dtype=torch.float64, device=dev)
                    dist.all_reduce(pred, op=dist.ReduceOp.MAX)
                    fits = pred.item() <= BIG_MEM_SHARE * card_bytes
                    log(f'{what}: predicted peak {pred.item() / 2**30:.2f} '
                        f'GiB of {card_bytes / 2**30:.2f} GiB a card: '
                        f'{"run" if fits else "not run"}')
                    if not fits:
                        out[str(budget)] = {
                            'not_run': 'predicted peak '
                            f'{pred.item() / 2**30:.2f} GiB over '
                            f'{BIG_MEM_SHARE} of the card'}
                        continue
                batch, attn = train_batch(budget, model)
                real = int(batch.cu_lens[-1])
                cell, _ = mesh_steps(plm, [batch] * BIG_MESH[0], steps,
                                     launches(L), what)
                ms = cell['ms_per_step']
                flops = 6 * n_params * real + 3.5 * attn
                cell.update(real_tokens=real,
                            real_tokens_per_s=real / ms * 1e3,
                            real_tokens_per_s_per_card=real / ms * 1e3 / w,
                            mfu=flops / (ms * 1e-3) / MFU_PEAK,
                            mfu_world=flops / (ms * 1e-3) / (MFU_PEAK * w),
                            peak_rss_gib=rss.read())
                losses += cell['losses']
                log(f'{what}: {ms:.2f} ms a step, {real / ms * 1e3:.1f} real '
                    f'tokens/s, MFU {cell["mfu"]:.4f} of one card '
                    f'({cell["mfu_world"]:.4f} of the {w}), peak '
                    f'{cell["peak_mem_gib"]:.2f} GiB, host '
                    f'{cell["peak_rss_gib"]:.2f} GiB')
                out[str(budget)] = cell
            # a fresh Adam's first updates (lr·sign(g) on every leaf) raise
            # the loss of random weights before it falls (phase 11's note;
            # 3.81 -> 6.26 -> 4.81 over 8 steps at 6 of these layers on an
            # H100 80GB HBM3), so the run must turn: its last loss below
            # its largest
            log(f'phase 20 (e) {BIG_SIZE}: losses over the run {losses}')
            if not losses[-1] < max(losses):
                fail(f'phase 20 (e) {BIG_SIZE}: the loss does not fall: '
                     f'{losses}')
            del plm
    del model
    torch.cuda.empty_cache()
    return out


def rope_row(T, H, D, dev):
    """H3 at ``T`` rows of ``H`` heads of ``D``: held against its plain
    version (:func:`check_rope`), then timed beside it and the bound (q
    and k read and written once, the tables' halves H3 reads)."""
    from esme_tpu_torch.ops import headsplit
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    err = check_rope(T, H, D, dev, seed=T + D)
    gen = torch.Generator(device=dev)
    gen.manual_seed(D)
    q, k = (randn((T, H * D), gen, dev) for _ in range(2))
    cos, sin = rotary_cos_sin(torch.arange(T, device=dev) % 1024, D)
    ms = cuda_ms(lambda: headsplit.rotary_qk(q, k, cos, sin, H), reps=20,
                 warmup=2)
    plain = cuda_ms(lambda: headsplit.rotary_qk_plain(q, k, cos, sin, H),
                    reps=5)
    nbytes = 4 * q.numel() * 2 + cos.numel() * 2
    b_ms, b_by = bound(nbytes, 6.0 * q.numel(), FP32_FLOP_PER_S)
    log(f'H3 T={T} H={H} D={D}: {ms:.4f} ms, plain {plain:.3f} ms, bound '
        f'{b_ms:.4f} ms by {b_by}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain, 'bound_ms': b_ms,
            'bound_by': b_by, 'library_ms': None, 'bytes': nbytes,
            'shape': f'T={T} H={H} D={D} bf16'}


def phase20_kernels(dev):
    """H9, H10 and H3 at phase 20's per-rank shapes on this card, each
    held against its plain version under phase 3's gates and timed beside
    it, its bound and the varlen library call per rank: ESM2-650M's (every
    rank of a 4-way ``seq`` split of the 50k batches: H9 on the inference
    batch, H10 on the train batch, H3 on a rank's 12,500 rows) and
    ``BIG_SIZE``'s (one rank of ``BIG_MESH``'s, whose ``seq`` is 1: the
    whole 10k train batch, 40 heads of D = 128)."""
    from esme_tpu_torch.models.config import ESM2_SIZES
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H
    big = ESM2_SIZES[BIG_SIZE]
    Hb = big['attention_heads']
    Db = big['embed_dim'] // Hb
    Tb = BIG_BUDGETS[0][0]
    _, cu, _ = packed_batch(BUDGET, seed=0)
    _, cub, _ = packed_batch(Tb, seed=2)
    n = max(w for w in CP_WORLDS)
    rows = {H9_NAME: time_rect(cu, dev, n=n),
            H10_NAME: time_rect_bwd(dev, n=n),
            H3_NAME: rope_row(BUDGET // n, H, D, dev)}
    big_rows = {H9_NAME: time_rect(cub, dev, H=Hb, D=Db, T=Tb, n=1,
                                   mask_skip=False),
                H10_NAME: time_rect_bwd(dev, H=Hb, D=Db, T=Tb, n=1),
                H3_NAME: rope_row(Tb, Hb, Db, dev)}
    for name, row in rows.items():
        row['d128'] = big_rows[name]
    return rows


def phase20_rank(rank, n, ports, tmp, profile_dir):
    """Rank ``rank`` of phase 20's ``n``: card ``rank``, then cells (a) to
    (e) in their worlds (:class:`_Worlds`), then on rank 0 the kernels'
    rows (:func:`phase20_kernels`); writes its results to
    ``tmp``/rank<r>.json. Any exception or failed gate ends the process
    with a non-zero code at once."""
    global RANK_TAG
    RANK_TAG = f' rank {rank}'
    try:
        torch.set_num_threads(RANK_THREADS)
        dev = torch.device(DEVICE, rank) if DEVICE == 'cuda' \
            else torch.device('cpu')
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        worlds = _Worlds(rank, ports, dev)
        seconds, t0 = {}, [time.perf_counter()]

        def done(key):
            now = time.perf_counter()
            seconds[key] = now - t0[0]
            t0[0] = now
            log(f'phase 20 {key}: {seconds[key]:.1f} s')
        res = {'rank': rank, 'device': str(dev), 'start_rss_gib': rss_gib()}
        res['a_context_parallel'] = cp_cells20(worlds, dev, profile_dir)
        done('a')
        res['b_dense'] = dense_cells20(worlds, dev, profile_dir)
        done('b')
        res['c_lora'] = lora_cells20(worlds, dev)
        done('c')
        # host memory is sampled from here on, off the timed steps of (a)-(c)
        rss = _RssPeak()
        res['d_checkpoints'] = ckpt_cells20(worlds, dev, tmp, rss)
        done('d')
        res['e_big'] = big_cells20(worlds, dev, rss, profile_dir)
        done('e')
        if rank == 0:
            res['kernels'] = phase20_kernels(dev)
            done('kernels')
        res['seconds'] = seconds
        res['peak_rss_gib_d_e'] = rss.read()
        with open(os.path.join(tmp, f'rank{rank}.json'), 'w') as f:
            json.dump(res, f, default=float)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)


def free_ports(k):
    ports = set()
    while len(ports) < k:
        ports.add(free_port())
    return sorted(ports)


def run_ranks(n, profile_dir):
    """Spawn phase 20's ``n`` rank processes and wait for them: fails (and
    kills the rest) as soon as one exits non-zero, or when
    ``RANKS_DEADLINE_S`` pass. Returns every rank's results."""
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    ports = free_ports(RANK_PORTS)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=phase20_rank,
                             args=(r, n, ports, tmp, profile_dir))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANKS_DEADLINE_S
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if codes == [0] * n:
                    break
                bad = {r: c for r, c in enumerate(codes) if c not in (None, 0)}
                if bad:
                    fail(f'phase 20: rank(s) exited with {bad}')
                if time.monotonic() > deadline:
                    fail(f'phase 20: ranks still running after '
                         f'{RANKS_DEADLINE_S} s')
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f'rank{r}.json')) as f:
                results.append(json.load(f))
    return results


def phase20_main(n, cards, profile_dir, phase_done, phase_s, build_s,
                 t_start):
    """Phase 20 after phases 1 and 2 (every card's line printed, every
    kernel built once here): the ranks' cells (:func:`run_ranks`), then
    the kernels' line (H9, H10, H3 at phase 20's per-rank shapes, with
    their launches on every rank of each cell), the measurements' line and
    the contract's last line. With ``profile_dir``, every rank's results
    in ``profile_dir``/phase20_ranks.json beside rank 0's tables."""
    results = run_ranks(n, profile_dir)
    phase_done(20)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, 'phase20_ranks.json'), 'w') as f:
            json.dump(results, f)
    parts = ('a_context_parallel', 'b_dense', 'c_lora', 'd_checkpoints',
             'e_big')
    summary, launches = {}, {}
    for part in parts:
        summary[part] = {}
        for key, cell in results[0][part].items():
            mine = [r[part].get(key) for r in results]
            if not isinstance(cell, dict):
                summary[part][key] = mine
                continue
            row = dict(cell)
            for field in ('ms_per_step', 'ms_per_batch', 'peak_mem_gib',
                          'write_s', 'save_s', 'restore_s', 'peak_rss_gib'):
                if field in cell:
                    row[f'{field}_by_rank'] = [c and c.get(field)
                                               for c in mine]
            if 'launches' in cell:
                launches[f'{part} {key}'] = [c and c['launches']
                                             for c in mine]
            summary[part][key] = row
    main_cell = 'b_dense ' + 'x'.join(map(str, DENSE_MESHES[1]))
    kernels = []
    for name, row in results[0]['kernels'].items():
        row = dict(row, name=name)
        if name == H3_NAME:
            row.update(route='cuda', source='esme_tpu_torch/csrc/rope.cu',
                       replaces='esme_tpu/ops/headsplit.py:119')
        row['launches'] = launches[main_cell][0][name]
        row['phase20_launches'] = {
            cell: [c and c[name] for c in per_rank]
            for cell, per_rank in launches.items()}
        if name == H3_NAME:
            row['phase20_inverse_launches'] = {
                cell: [c and c['rope_inverse'] for c in per_rank]
                for cell, per_rank in launches.items()}
        got = [c[name] for c in launches[main_cell] if c]
        if len(got) != math.prod(DENSE_MESHES[1]) or min(got) < 1:
            fail(f'phase 20: {name} was not launched on every rank of '
                 f'{main_cell}: {got}')
        kernels.append(row)
    for kd in kernels:
        log(f"{kd['name']} (phase 20's shapes): {kd['ms']:.4f} ms (bound "
            f"{kd['bound_ms']:.4f} ms by {kd['bound_by']}), plain "
            f"{kd['plain_ms']:.3f} ms, library {kd['library_ms']}; "
            f"launches a step on each rank of {main_cell}: "
            f"{kd['phase20_launches'][main_cell]}")
    measured = {'cards': cards, 'ranks': n,
                'model': f'ESM2 {MODEL} bf16 and {BIG_SIZE}, seed-0 random '
                         'weights',
                'phase20': summary,
                'seconds_by_rank': [r['seconds'] for r in results],
                'start_rss_gib_by_rank': [r['start_rss_gib'] for r in results],
                'peak_rss_gib_d_e_by_rank': [r['peak_rss_gib_d_e']
                                             for r in results],
                'phase_s': phase_s, 'build_s': build_s,
                'torch': torch.__version__, 'cuda': torch.version.cuda,
                'wall_s': time.perf_counter() - t_start}
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps(measured), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def qlora_size(model, n_params, what):
    """Phase 12 (g): phase 14's adapters on a size's quantized model, then
    ``MaskedPLM(lora_only=True, remat='full')`` with checkpointing on phase
    5's 10k batch (:func:`train_cell`: launches exact, losses finite, ms a
    step, real tokens/s, peak memory) and :func:`trainer_checks` after its
    steps (adapters moved, the trunk bit-unchanged, no frozen or quantized
    leaf with a gradient)."""
    import functools
    from esme_tpu_torch.train import MaskedPLM
    ft_model(model.device, lift_b=True, model=model)
    frozen_names, trained_names = lora_leaves(model)
    frozen = host_copies(model.params, frozen_names)
    trained = host_copies(model.params, trained_names)
    cell = train_cell(
        model, functools.partial(MaskedPLM, lora_only=True, remat='full'),
        'qlora', TRAIN_CELLS[0][1], True, SIZE_QLORA_REPS, False, n_params,
        None, what=f'{what} LoRA ', after=lambda plm: trainer_checks(
            plm, plm.model.params, frozen, trained, f'{what} LoRA MaskedPLM'))
    log(f'{what} LoRA (rank {FT_RANK} on query, value, output; '
        f"remat='full'): {cell['ms_per_step']:.2f} ms a step, "
        f"{cell['real_tokens_per_s']:.1f} real tokens/s, peak "
        f"{cell['peak_mem_gib']:.2f} GiB, optimizer "
        f"{cell['optimizer_bytes']:,} bytes")
    return cell


def _leaf_pairs(got, ref, path=()):
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from _leaf_pairs(got[k], v, path + (k,))
        else:
            yield '.'.join(path + (k,)), got[k], v


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _busy_ms(stats):
    """Device ms of the kernels and copies themselves in a profile's
    ``key_averages()``: CPU-side ops also carry the device time of what
    they launch, and CUPTI's "Command Buffer Full" is the host waiting for
    room in the launch queue."""
    return sum(e.self_device_time_total for e in stats
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation
               and e.key != 'Command Buffer Full') / 1e3


def _profile(run, out_dir, table, what):
    """Device time by kernel over one call of ``run``, as a table in
    ``out_dir/table``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    busy = _busy_ms(stats)
    wall = start.elapsed_time(end)
    with open(os.path.join(out_dir, table), 'w') as f:
        f.write(stats.table(sort_by='self_device_time_total', row_limit=40))
    log(f'profiled {what}: device busy {busy:.2f} ms of {wall:.2f} ms '
        f'({1 - busy / wall:.1%} idle); table in {out_dir}/{table}')


if __name__ == '__main__':
    main(sys.argv[1:])
