#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and the script exits
non-zero without the result line:

1. device: a CUDA card is required (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit`` and turns TF32 off.
2. build: compiles every CUDA source of the port (``paddle_tpu_torch/
   csrc``: ``lstm_seq.cu``, ``gru_seq.cu``, ``opt_update.cu``,
   ``crf.cu``, ``flash_attn.cu``, ``lstm_cell.cu``, ``ctc.cu``,
   ``gru_cell.cu``; one nvcc
   per source, started together) and prints the seconds and the register
   report.
3. kernel check: the primal LSTM recurrence kernel against its plain
   PyTorch version on the card, at T=100 with a ragged mask and nonzero
   h0/c0, in both time directions, for every BENCH_SHAPES (batch, hidden)
   pair and at the serving path's own shapes, on each route the shape has
   (``lstm_route``: the persistent one, one cooperative launch per
   sequence, and the per-step one, forced with ``per_step=True``; (128,
   1280), (256, 1280) and (512, 512) are above the line, per-step only);
   ys, hT and cT within rtol 1e-4 / atol 1e-5 (summation order over K=H
   and 100 steps). Times of both routes: CUDA events (median of 10) and
   ``torch.profiler`` device time, ``speedup_*`` in each row.
4. train kernel check: at every BENCH_SHAPES pair (T=100, ragged mask,
   nonzero h0/c0), on each route: the residual forward kernel (ys, hs,
   cs, gates; rtol 1e-4 / atol 1e-5) and the whole backward (the
   reverse-chain kernel on the persistent route, two runs bit-equal; the
   step kernel and a product per step on the other; every gradient, per
   tensor within 1e-4 of the tensor's largest entry + 1e-5: sums over T*B
   rows) against the backward with the plain step; on the persistent
   route the chain alone beside the per-step route's loop alone;
   reverse through ``LstmFunction`` at (64, 1280). Times: CUDA events,
   median of 10 calls after warmup, and ``torch.profiler`` device time of
   the forward's kernel and of every kernel of the backward, beside the
   bounds (the chain's 2 B 4H H operations a step). Then the optimizer
   kernels (one multi-tensor launch a step, ``adam_multi_kernel`` and
   ``momentum_multi_kernel``): the grouped update against ``_apply_one``
   per tensor at the parameter list of every path that trains on the
   card (the h=1280 classifier, the full-width seq2seq with and without
   its self-attention block, the tagger, the acoustic model, the
   ``lstm_step`` decoder) with per-tensor lr and decay (Adam at t = 3),
   at a list of views at storage offset 1 (scalar moves) and at a list
   of 1000 tensors (three tables): max abs error 0 (the kernels take the
   plain chain's roundings), the inputs unchanged, one launch per table
   (``opt_update.table_capacity()`` tensors). The per-tensor kernels
   (one launch a tensor), the "before" of the grouped ones, at every
   size of those lists and at 1, 7 and 1025, aligned and at storage
   offset 1: bit-equal to ``_apply_one``, timed by CUDA events and
   device time. Each path's
   whole step update timed four ways: the per-tensor loop, the grouped
   launch, ``torch._fused_adam_`` over the same list (Adam; eps /
   sqrt(1 - beta2^t) gives Paddle's update) and the bytes bound (28 B an
   element for Adam, 20 for Momentum), by CUDA events around one call,
   by CUDA events over 100 calls back to back (the device's time a call
   where the host path is the shorter) and, for the port's kernels, by
   device time (``torch.profiler`` at the known launches a call); a
   device reading below the bytes bound of a list larger than the L2 is
   refused (null: a trace that lost launches). The host split of the
   grouped call (routing, allocation, launch, whole; median of 5
   interleaved rounds of 400 calls) at the tagger's and the acoustic
   model's lists.
   ``python3 chip_smoke.py --opt-kernels`` runs only this, ~1 min, into
   ``chiprun_out/opt_kernels.json``.
5. GRU kernel check: at every GRU_SHAPES (batch, hidden, T) — the seq2seq
   path's (50, 512, 50), (64, 256, 100), (1, 512, 50) and the CTC
   acoustic model's (16, 1024, 400) — and at GRU_ABOVE_LINE (16, 1536,
   50), above the persistent route's line, with a ragged
   mask, nonzero h0 and the two non-contiguous column slices of one w0
   [H, 3H] as the weights, on each route the shape has (``gru_route``:
   the persistent one, one cooperative launch per sequence or reverse
   chain, and the two-launch one, forced with ``two_launch=True``): the
   primal kernel in both directions and the residual kernel (ys, hT; hs,
   gates) within rtol 1e-4 / atol 1e-5 of the plain versions, every
   gradient through ``GruFunction`` (both directions) per tensor within
   1e-4 of the largest entry + 1e-5 of autograd through the plain loop,
   and the backward (the chain kernel, or the per-step kernels) likewise
   against the backward with the plain step; two chain runs bit-equal.
   Times of both routes: CUDA events around the primal and residual
   forward, the whole backward, the chain alone and the two-launch
   route's per-step loop alone; ``torch.profiler`` device time of the
   residual forward, the chain kernel and every kernel of the backward;
   the plain versions; the bounds (the chain's 6 B H^2 T operations).
   The GRU cell at GRU_CELL_SHAPES (seq2seq's batch 50, the beam
   search's 32 and 4 rows, batch 1; H = 512) on both routes (the cluster
   route, one launch a call, and the two-launch route forced with
   ``two_launch=True``): both entries' forward against the plain math
   (rtol 1e-4 / atol 1e-5), two runs bit-equal, the recompute backward,
   one device launch a call (two forced); CUDA-event ms (median of 50),
   profiler device ms, ``speedup_*``; at (50, 512) the host split of the
   launch path in us (checks, allocation, device guard and stream,
   data_ptr, the ctypes call, the whole path, the entries and their
   autograd share), the baseline spelling (per-tensor checks, a device
   guard, ``current_stream()``, the two-launch entry) replayed beside
   today's, interleaved in 5 rounds; the cluster kernel at cluster sizes
   16 and 8 where both plans fit (CLUSTER_SHAPES).
5b. LSTM cell kernel check: at the LSTM-step decoder's decode (32 rows:
   8 sources x beam 4), training (50) and one row, H = 512, nonzero
   peepholes: both entries' h and c within rtol 1e-4 / atol 1e-5 of
   ``lstm_cell_plain``, the gradient through ``LstmCellFunction`` per
   tensor within 1e-4 of the largest entry + 1e-5 of autograd through the
   plain version; CUDA-event time, device time (``torch.profiler``),
   plain time and bound; at 32 rows the host split as for the GRU cell.
6. CRF kernel check: at the tagger's training shape (B=64, T=80, C=23;
   ragged lengths 1-80, an all-padding row, two forbidden transitions at
   -1e4), its serving shape (B=1), (16, 80, 128) and (16, 80, 256) (the
   forward's E read from L2 at 256), and at CRF_BIG_SHAPES (4, 40, 257)
   and (2, 20, 1000), above the earlier kernels' 256 classes: the
   forward kernel's alphas and log Z within rtol 1e-4 / atol 1e-5 of the
   plain loop (and its global-memory path bit-equal where E fits shared
   memory), the backward's gradients per tensor within 1e-4 of the largest
   entry + 1e-5 of the plain analytic backward (forbidden ones finite and
   below 1e-6, two runs bit-equal), the Viterbi paths identical to the
   plain decode's (scores within 1e-5); the CUDA kernels of 20 calls of
   each wrapper (the backward's two kernels, at most two launches a call
   and nothing else: C <= 32 the one-launch backward and the sum over the
   batch, above the beta chain and the marginal pass; the forward's and
   the Viterbi's one).
   Each kernel's device time (``torch.profiler``, 20
   calls), CUDA events around one wrapper call (median of 50) and the
   plain version's time (median of 10), beside the bounds for this mask's
   live steps: bytes or operations, and the chain bound, the most live
   steps of any row times a step's floor (``crf_chain_floor``: the
   chains' own step functions, the alpha, beta and Viterbi variants, one
   warp at C <= 32, 20,000 steps, no global memory). At C <= 256 the
   earlier forward, backward and Viterbi kernels (``crf_alpha_fwd_lanes``,
   ``crf_bwd_inline``, ``crf_viterbi_scratch``, in their wrappers'
   earlier spelling) are checked and timed beside them; at the tagger's
   shapes, the host split of the three wrappers' launch paths beside that
   spelling, interleaved in 5 rounds. ``python3 chip_smoke.py
   --crf-kernels`` runs this phase alone, into
   ``chiprun_out/crf_kernels.json``.
6b. CTC kernel check: at CTC_SHAPES (B, T, L) — the acoustic model's (16,
   400, 66: S = 133) with ragged frames and transcripts, an empty
   transcript, an infeasible row, repeated labels and padded frame tails;
   its batch 1; LibriSpeech-length utterances (16, 1600, 240: S = 481) —
   both operand forms of the kernels. Gathered (JAX's operands): the
   forward kernel's alphas and ll within rtol 1e-4 / atol 1e-5 of
   ``ctc_forward_plain`` (NEG entries equal), the backward kernel's demit
   within 1e-4 of its largest entry + 1e-5 of ``ctc_bwd_plain``. Fused
   (the log-probs and labels): the forward (both chains in one launch)
   against ``ctc_fused_forward_plain`` (alphas, betas, ll), the posterior
   pass's d log_probs against ``ctc_fused_bwd_plain``, the no-grad
   forward's ll the same bits. Two backward runs bit-equal, every output
   finite, -ll on the feasible rows within 1e-4 relative of
   ``torch.nn.functional.ctc_loss`` (which returns inf where JAX returns
   about 1e30). Times as in phase 6 for each kernel (the fused forward
   with and without the beta chains), the library yardstick
   ``F.ctc_loss`` forward and backward with the names of the kernels it
   ran, the port's path (``layers/chain.py:ctc_loss`` from the log-probs)
   beside the spelling before the fused kernels, and the CUDA kernels of
   one forward and backward of the path (the fused pair alone: no gather,
   no scatter); the bounds, and the chain bound: the most live frames of
   any row times a frame's floor, measured by ``ctc_chain_floor`` (one
   warp, T = 100,000 frames of the chain's step at the shape's states a
   lane). At the acoustic model's shape, the host split of both fused
   wrappers' launch paths beside ``ctc_loss``'s spelling before them,
   interleaved in 5 rounds. Then the fused kernels at CTC_BEYOND_SHAPES,
   sizes they refused before: (2, 50) frames at C = 60,000 (L = 10; the
   sorted posterior pass) and (1, 10,500) frames of 29 classes at S =
   20,001 (the wide chains): the forward and the posterior pass against
   their plain versions as above, two backward runs bit-equal, the loss
   and its gradient against the CPU plain path (within 1e-5 relative;
   1e-3 of the largest entry + 1e-6), device and event times, the plain
   versions, ``F.ctc_loss`` forward and backward, the bounds. Then the
   gathered kernels (``ctc_alpha_fwd``, ``ctc_bwd``) at
   CTC_GATHERED_BEYOND, S = 16,385 and 20,001 over 2000 frames (the wide
   route they refused before): against their plain versions as above
   and against the fused form on the same inputs (alphas, ll; d
   log_probs against demit summed per class), two backward runs
   bit-equal, times, ``F.ctc_loss``, the bounds.
   ``python3 chip_smoke.py --ctc-kernels`` runs this phase alone, into
   ``chiprun_out/ctc_kernels.json``.
7. flash-attention kernel check: at every FLASH_SHAPES (B, N, Tq, Tk, D)
   — the attention seq2seq path's (50, 4, 50, 50, 128) with kv lengths
   10-50 and one all-padding row, its batch 1, a causal cross-attention
   (2, 4, 200, 333, 64), a long self-attention (2, 4, 4096, 4096, 128)
   non-causal and causal, and query rows that see no key: an all-padding
   kv row at (2, 4, 64, 333, 64) and causal (2, 4, 333, 200, 64), where
   JAX divides such a row by Tk padded to a multiple of min(256, Tk); and
   head widths 32 (an instance) at (50, 4, 50, 50, 32) with an
   all-padding row and 40 (padded with zero columns to 64) at causal (2,
   4, 200, 333, 40) — and at every FLASH_WIDE_SHAPES row on the
   wide-head path (128 < D <= 1024, split TF32 on the tensor cores with
   D split across a block's warps: (2, 4, 300, 300, 256) both ways with
   an all-padding kv row, causal (2, 4, 333, 200, 256), causal (2, 4,
   200, 333, 160), (2, 2, 64, 64, 1024)) and every FLASH_SPLIT_SHAPES
   row on the split-row path (D > 1024: (1, 2, 64, 64) at D = 1056 and
   2048, with an all-padding kv row at 1056, causal (1, 2, 80, 64) at
   2048) —
   the forward kernel's o and row statistics
   within rtol 1e-4 / atol 1e-5 of ``blockwise_plain``, the backward
   kernels' gradients per tensor within 1e-4 of the largest entry + 1e-5
   of ``flash_bwd_plain`` and, where it is the same function, of
   autograd through ``mha_plain``, two
   backward runs bit-equal, every output finite. Times: CUDA events
   around each wrapper call (median of 10), the kernels' device time
   (``torch.profiler``; each kernel's mean in the trace record), the
   plain versions, and the library yardstick
   ``scaled_dot_product_attention`` (the same additive -1e9 mask, TF32
   off; forward, backward, both, by CUDA events and the forward and the
   backward by device time; the backend that ran; where the mask is all
   ones also without the bias, ``is_causal=True`` for a square causal,
   and the kernels ranked against the faster device reading), beside
   the bounds by the visible (query, key) pairs at the f32 rate and in
   split TF32 (three passes at the dense TF32 rate). At the attention
   seq2seq path's shape, the host split of both wrappers' launch paths
   (checks, alignment, allocation, device guard and stream, data_ptr,
   the ctypes call, the whole path, the entries and their autograd
   share), the baseline spelling (per-tensor checks, a device guard,
   ``current_stream()``) replayed beside today's, interleaved in 5
   rounds. The layer check of the wide-head path:
   ``multi_head_attention(size=512, num_heads=2)`` (D = 256) forward and
   backward on the card against the same layer on the CPU plain path
   (y within rtol 1e-4 / atol 1e-5, every parameter gradient per tensor
   within 1e-4 of its largest entry + 1e-5; one launch of each wrapper),
   5 times over (20 under ``--flash-kernels``), each anew on both
   devices; a failing repeat prints where the card and the CPU parted
   (``_diagnose_wide_layer``, with the host CPU) and the others still
   run.
8. train: ``lstm_text_classifier`` at its widest published width (vocab
   30000, embed 128, hidden 1280, 2 LSTM layers, 2 classes) trained by
   ``python -m paddle_tpu_torch.trainer.cli --job train`` with
   ``Adam(learning_rate=2e-3)`` for 3 passes over 4 fixed batches of 64
   (lengths 1-100, padded to 100; ids from the seed, labels from a rule
   on the ids), saving into ``--save_dir``: the cost must be finite and
   fall from pass 0 to pass 2, and the CLI's kernel counts (a fresh
   process: they start at 0) must show the residual forward launched and
   one Adam launch a step (the grouped kernel), the LSTM on the persistent
   route (one reverse-chain launch
   per layer and step, 0 ``lstm_bwd_step``, one device launch per forward
   call). One pass with the CLI's default optimizer, Momentum, drives the
   Momentum kernel the same way (one launch a step; the same route
   checks). Then one batch's
   loss and every parameter gradient at full width (16 rows, lengths
   1-100) from the trained checkpoint, on the card against the plain path
   on the CPU, per tensor within 1e-3 of the CPU tensor's largest entry
   + 1e-6 (float32 through 100 recurrent steps each way; the plain path
   in float64 is reported beside both as the exact reference); one step
   on the card from the checkpoint timed and traced (``torch.profiler``:
   device busy time, idle share, top kernels); then ``--job merge`` of
   the save dir.
9. serve: the merged trained model served by ``--job serve`` (max_batch
   64, length buckets 32,64,128). Single samples and a rows batch of
   lengths 1-100 must answer softmax rows that sum to 1, repeat
   identically, match the port's plain path run on the CPU from the same
   file, and go through the kernel on the persistent route (its launch
   count, read from the server's /healthz before and after the requests,
   grows by as many device launches as calls). SIGTERM must drain the
   server to exit 0.
10. seq2seq train: ``seq2seq_attention`` at the seqToseq demo's published
   width (dicts 30000, embed 512, hidden 512) trained by ``--job train``
   with ``Adam(learning_rate=5e-4)`` for 2 passes over 4 fixed batches of
   50 (source lengths uniform in 10-50, padded to 50; ids from the seed;
   the target is the source reversed): the cost must be finite and fall
   from pass 0 to pass 2, and the fresh process's counts must show the
   residual GRU kernel, the GRU backward's reverse-chain kernel (and no
   per-step backward), the GRU cell (one device launch a call: the
   cluster route) launched and one Adam launch a step. Then the
   full-width gradients (8 rows) from the trained checkpoint, card
   against CPU as in phase 6, and ``--job test`` of the checkpoint on the
   card, whose counts must show the primal GRU kernel and the cell's
   inference entry launched (one device launch a call). Then the same for the model with its encoder
   self-attention block (``seq_parallel="ring"``, 4 heads of 128; no
   sequence mesh, so dense): its counts must also show the flash forward
   and backward kernels in training and the forward in ``--job test``.
10b. seq2seq generation served (path A): ``--job merge`` of
   ``seq2seq_attention(generating=True)`` (beam 4, outputs of up to 50
   words) from phase 10's save dir, whose checkpoint must hold every
   generating parameter; ``--job serve`` of it (max_batch 8, length
   buckets 16,50); ``POST /v1/generate`` of three single sources
   (lengths 1, 23, 50), a repeat and one ``rows`` call of 8: 4 beams
   each, best first, scores within 1e-4 relative of the port's CPU plain
   path on the same file, rank by rank, and tokens equal to its, unless
   the searches parted at a near-tie that float32 rounding decides: then
   the CPU's teacher-forced scores of the card's beams must equal the
   card's within 1e-5 relative (``_compare_beams``); the repeat answers
   the same; an off-menu beam size is the typed 400 with the menu; /healthz
   shows gru_cell_infer launches growing, one device launch each (the
   cluster route at 4 and 32 rows); SIGTERM drains to exit 0.
11b. LSTM-step decoder (path B): the lstmemory_group form of the
   seqToseq decoder at 30000/512/512 (``lstm_step`` over fc([word, h])
   with its peepholes, the cell state carried through ``get_output``,
   booted from the average source embedding), trained by ``--job train``
   (Adam(5e-4), 2 passes over phase 10's batches: the cost falls, the
   counts show lstm_cell launched and one Adam launch a step), its
   full-width gradients (8
   rows) card against CPU, then the same step in a beam search (beam 4,
   up to 50 words) of 8 sources from the trained checkpoint on the card
   (counts reset just before, read just after: lstm_cell_infer launched)
   and on the CPU, compared as in phase 10b; the full scan identical to
   the chunked decode.
11. tagger: ``bilstm_crf_tagger`` at CoNLL-2000 width (word dictionary
   6778, embed 128, hidden 128, 23 labels) with the reference demo's
   labelled decode and its ``sum`` error and ``chunk`` F1 evaluators,
   trained by ``--job train`` with ``Adam(learning_rate=5e-3)`` for 3
   passes over 4 fixed batches of 64 synthetic sentences (lengths 5-78,
   padded to 80; tags from a rule on the words): the cost must fall and
   the counts show the CRF forward, backward and Viterbi kernels (the
   forward and the backward exactly once a step), the
   residual LSTM kernel launched, one Adam launch a step, and the LSTM on
   the persistent
   route (one reverse chain per direction and step, 0 ``lstm_bwd_step``). Then the
   full-width gradients (8 rows) card against CPU as in phase 7, ``--job
   test`` on 2 more batches (cost, error, chunk_f1; the CRF forward once
   a batch, the Viterbi and the primal LSTM kernels launched, the LSTM
   persistent), ``--job merge`` with
   outputs = the decode, and ``--job serve`` of it (length buckets 32,80):
   3 single sentences (lengths 1, 23, 78) and one call of 16 rows answer
   the Viterbi ids of the CPU plain path on the same file, exactly, and
   /healthz counts crf_viterbi launches.
11c. CTC acoustic model: DeepSpeech2's width as PaddlePaddle released it
   (161-dim spectrogram frames, 3 bidirectional GRU layers of 1024, fc of
   29 = 28 characters + blank, ``warp_ctc_layer(blank=28,
   norm_by_times=True)``, the ``ctc_edit_distance`` evaluator; DS2's conv
   layers and batch norm left out; ~45 M parameters), trained by ``--job
   train`` with ``Adam(learning_rate=2e-4)`` (at DS2's 5e-4 the cost of
   the model without its batch norm rose) for 3 passes over 4 fixed
   batches of 16 synthetic utterances (100-400 frames, T/10-T/6
   characters, each frame its character's or the silence's fixed random
   prototype plus noise): the cost must fall and the counts show the fused
   CTC forward and posterior pass once a step (no gathered CTC kernel),
   the residual GRU kernel, one Adam launch a step and one reverse-chain
   launch per GRU
   layer and step (72), with no per-step GRU backward. Then the full-width gradients (4 rows, one with an
   empty transcript) card against CPU as in phase 8, one step on the
   card from the checkpoint timed and traced (``torch.profiler``: device
   busy time, idle share, top kernels), and ``--job test``
   on 2 more batches (cost, ctc_edit_distance; the fused CTC forward and
   the primal GRU kernel launched, the posterior pass not).
12. the image slice (cuDNN's convolutions and torch's pools with TF32
   off; no Pallas kernel lies on it): ResNet-50 as
   ``__graft_entry__.py:entry()`` builds it (``resnet(50,
   classes=1000, image_size=224)``, 25,610,152 parameters from
   ``init_params`` with a seeded generator, an NHWC feed [8, 224, 224,
   3]) on the card against the port's CPU path: (a) ``train=True``, the
   output and the 106 moving statistics; (b) ``train=False`` on (a)'s
   statistics; (c) ``train=False`` at ``init_params`` (moving variance
   0): NaN in the same places of the output; rtol 1e-4 / atol 1e-5. In
   each, every layer run on the card from the CPU's values of the layers
   it reads, and the fc's pre-softmax output, against the CPU's (rtol
   1e-4, atol 1e-5 of the layer's largest value; in (c) the layers below
   the overflow), since (b)'s softmax saturates and (c)'s output is NaN.
   The (b) forward by CUDA events and device time (median of 5), a
   profiled call's idle share and top kernels, beside its f32 operations
   bound (2 B Ho Wo fs^2 Cin/g Cout over the convolutions, and the fc,
   from the graph's shapes). Its training at full width: the loss and
   every gradient of a batch of 2 on the card against the CPU (within
   1e-3 of each tensor's largest entry + 1e-6) in float64, and in float32
   with the float64 run's ReLU masks replayed (float32 alone flips masks
   near 0 and misses the exact gradients by ~150 times the tolerance on
   both devices alike: reported, the card's at most twice the CPU's + 1);
   the moving statistics of the step card against CPU and folded into
   the parameters by ``train_step``; the ``Momentum(0.01, 0.9)`` step at
   batch 8, median of 5, one ``momentum_multi_kernel`` launch a step.
   LeNet (``lenet_mnist``) through ``--job train`` (Momentum, 3 passes
   over 4 batches of 64 synthetic digits: each class a fixed random
   prototype plus noise, from the seed; the classification error falls),
   ``--job test``, ``--job merge`` and the predictor on the card and on
   the CPU (single rows and a batch of 16 within 1e-5).
   ``python3 chip_smoke.py --image`` runs this phase alone, into
   ``chiprun_out/image_slice.json``.
13. the rest of training, at the classifier's full width: (a)
   ``--grad_accum_steps``: one batch's gradient at k = 2 and 4 against
   the whole batch's (per tensor within 1e-4 of its largest entry +
   1e-5), ``lstm_route`` at the microbatch's rows, 2 passes of ``--job
   train`` with Momentum at k = 2 against k = 1 (pass costs within 1e-4
   relative; one Momentum launch a step, a reverse chain per layer and
   microbatch; Adam's sign-like first steps would amplify roundoff) and
   the Adam config at k = 2 beside phase 8's k = 1; (b) ``prev_batch_state`` over 3 batches of 16 rows, card
   against the CPU plain path (costs within 1e-4 relative, the carried h
   and c within 1e-4 of the largest + 1e-5, the LSTM kernels launched
   with a non-zero h0); (c) ``async_load_data`` (depth 2) against
   synchronous loading, 5 interleaved repeats: the parameters bit-equal,
   each mode's wall ms a step (median and spread); the caller's time of
   a foreground and of a background save of 24,186,882 parameters and
   their Adam slots; (d) the classifier with ``dsl.dropout(0.5)`` before
   its softmax fc, ``--save_dir --saving_period_by_batches 2
   --background_save``, 2 passes: twice without a kill (the same bits),
   then killed by ``PADDLE_TPU_CHAOS_PLAN`` (``exit`` at step 7, between
   two saves) and run again: the final checkpoint bit-equal, every key;
   (e) dropout's keep mask on the card (within 4 sigma of the binomial
   mean, the same bits twice, one stream a layer, the gradient the mask
   times the upstream), the dropout classifier's cost falling over 3
   passes; (f) ``--job
   test`` of (d)'s checkpoint with ``classification_error``, ``auc``,
   ``precision_recall``, ``pnpair`` and three printers, card against the
   CPU plain path (values within 1e-6, the printed numbers within 1e-5);
   (g) ``--job time`` (its step times) and ``--job checkgrad`` of a
   small LSTM classifier (autograd through the kernels against float64
   central differences). The CLI jobs run in this process (each resets
   the kernel counts its summary reports), but the killed one, a process
   of its own. ``python3 chip_smoke.py --training`` runs this phase
   alone, into ``chiprun_out/training.json``.
14. the layer plane: (a) DeepSpeech2 as PaddlePaddle/models released it
   (``_DS2R_MODEL``: ``deep_speech_2/layer.py``'s conv group of two conv
   + batch norm(brelu) layers over the 161 x 400 spectrogram, 32 filters
   of 11 x 41 (stride 3 x 2) and 11 x 21 (1 x 2), ``block_expand`` into
   134 steps of 1312, 3 bidirectional batch-normed GRUs of 1024 with act
   relu, fc(29), ``warp_ctc(blank=28, norm_by_times)`` and the softmax
   ``mixed`` output) trained through ``--job train`` (Adam(2e-4), 2
   passes over 4 batches of 16; the cost falls; one ``ctc_fused_fwd``,
   one ``ctc_fused_bwd`` and one ``adam`` launch a step, no GRU kernel:
   relu takes the inline step, as in the JAX package); its parameter
   count; the gradients of 4 rows (one empty transcript) card against
   the CPU within 1e-3 of each tensor's largest entry + 1e-6, directly or,
   where float32 flips a relu/brelu kink, in float32 with the CPU's
   float64 masks replayed on both (each within the tolerance of the other
   and of float64); the probabilities on the card against the CPU; a
   profiled step (``step_trace``); ``--job test`` card against the CPU
   plain path (cost within 1e-4 relative, ``ctc_edit_distance`` within
   one character); (b) the simple-RNN branch (one shared projection, two
   ``recurrent(act=brelu)``): one pass, its cost printed, and one batch's
   gradients the same way; the CTC kernels against their plain versions
   at the path's (16, 134, S = 133), as phase 6b; (c) every layer type
   this slice ports (``layer_cases``: the tier-1 matrix's shapes and
   inputs), forward and gradient on the card against the CPU (values
   rtol 1e-4 / atol 1e-5, gradients within 1e-4 of the largest entry +
   1e-5, integer outputs equal), ``sampling_id`` on one-hot rows, by its
   frequencies over 20,000 draws and its repeat under one seed.
   ``python3 chip_smoke.py --layers`` runs this phase alone, into
   ``chiprun_out/layers.json``.
15. the last layer types, each model held against the CPU (synthetic
   batches from seed 2017): (a) a nested GRU text model
   (``nested_text``: ``sequence_nest_rnn.conf``'s topology at seq2seq's
   widths, 30000 / 512 / 512, batch 50 documents of 2-8 sentences of
   5-30 words through the feeder's nested slot; the inner step a 3H
   projection and ``gru_step``): nested == flat on the card, card
   against CPU (loss rtol 1e-4, gradients within 1e-3 of the largest
   entry + 1e-6), 4 batches x 3 passes of Adam(5e-4) (the cost falls;
   the step's ms, busy ms and idle share), subseq and the TO_SEQUENCE
   max / seqlastins on the nested out-link; (b) the book's word2vec
   N-gram (2048 words, embedding 32, fc 256) with hsigmoid and with nce,
   card against CPU (nce's negatives replayed), then trained; (c)
   SSD300's head (six maps, 8732 priors, 21 classes, batch 32): the
   priors bit-equal, the loss and the heads' gradients, every
   ``detection_output`` row, 4 Momentum steps, the forward's and
   ``detection_output``'s ms and device ms; (d) the VAE (784 / 256 /
   32, eps replayed for the comparison, then trained; the decoder from
   z); (e) ``moe`` at d 512, hidden 2048, 8 experts on 50 x 64 padded
   tokens at a capacity that drops tokens and at the default.
   ``python3 chip_smoke.py --last-types`` runs this phase alone, into
   ``last_types.json`` in ``OUT_DIR``.
16. the serving tier, through ``--job merge`` and ``--job serve``
   processes, all started together and measured one at a time (the CPU
   references computed while they start): (a) the generating seq2seq (30000/512/512, beam 4, <= 50
   words) merged from phase 10's save dir and served twice (max_batch 8,
   one length bucket of 50), with ``--serving_continuous_batching`` and
   without: 12 sources of 1-50 words (seed 2033) sent at once with a
   request of a 1-ms deadline (the typed 504); each answer against the
   port's CPU plain path on the same file by ``_compare_beams``' rule
   (near-ties counted, traced on the card at 8, 4, 2 or 1 copies of the
   source), the modes apart only at such near-ties; continuous mode
   admits after its first chunk, launches ``gru_cell_infer`` once a
   session step (decode_chunks_total x 8) and the encoder's two
   ``gru_seq`` primal kernels at each admission; with buckets 16,50 the
   server logs the stand-down and serves convoy; per-request p50 / p90,
   device decode steps, chunks, lane occupancy of both modes; (b) phase
   8's classifier (30000/128/1280) merged fp32, ``--quantize bf16`` and
   ``--quantize int8`` and served: ``/healthz``'s quant block (the gate
   checked and passed, its max delta), ``+bf16`` / ``+int8`` versions,
   16 rows of 1-100 words within the tier's gate tolerance of fp32's and
   within 1e-5 of the CPU plain path on the same file, one persistent
   ``lstm_seq`` launch a layer and batch; the parameter bytes resident on
   the card and the peak above them in one 64-row request, per tier
   (int8 <= 0.3 and bf16 <= 0.55 of fp32's); a drifted int8 file
   (JAX's ``_drifted_int8``: a table times -3, each in turn, then every
   scale times 100, until the gate refuses it in this process) makes the
   server exit non-zero with ``quant_gate`` in its log, never ready; (c)
   the generating seq2seq merged ``--quantize int8`` and served with
   continuous batching: the gate stands down by name (generation-only),
   4 answers held against the CPU path on the same file as in (a).
   ``python3 chip_smoke.py --serving`` runs this phase alone (after one
   training pass of the classifier and of seq2seq), into
   ``serving.json`` in ``OUT_DIR``.
17. mixed-precision training (``--compute_dtype bfloat16``): (a) the
   bf16 forms of the LSTM sequence kernels (K1: primal and residual
   forward; K2: the reverse chain; on the tensor cores, ``lstm_bf16
   _kernel`` and ``lstm_bf16_chain_kernel``) at the classifier's lstm0 (64, 1280,
   100) and at batch 1, and of the GRU's (K3, K4; on the tensor cores,
   ``gru_bf16_kernel`` and ``gru_bf16_chain_kernel``) at the acoustic
   model's first layer (16, 1024, 400) forward and reversed and at batch
   1 (the chain bit-equal over two runs; at the first shape also at 16
   units a block, beside the plan's 8)
   (``_inputs`` / ``_gru_inputs`` at bf16, ragged masks), each against its
   plain bf16 version on the card: values and gradients within 2e-2 of
   each tensor's largest entry, and no farther from the f32 computation
   of the same widened inputs than twice the plain bf16 version plus
   1e-3 of the f32 result's largest entry; again at T = 3 (BF16_SHORT_T,
   before the recurrence amplifies the 1-ulp roundings in which the
   kernel's sum order and the plain version's differ), where each result
   keeps the plain version's bf16 rounding points: at most 1 % of its
   elements more than one bf16 ulp of their own value from the plain
   version, none more than 4 ulps of the largest entry (``_bf16_ulps``);
   at the path shapes CUDA-event and profiler ms, the
   f32 forms' ms at the widened inputs, the plain ms and the bound (2
   bytes a bf16 element and 4 an f32 one over HBM, or the products at
   989.4 TFLOP/s dense BF16); (b) the classifier at full width through
   ``--job train`` (4 batches x 3 passes), ``test`` and ``time`` with
   ``--compute_dtype bfloat16``: lstm0 on the bf16 forms and lstm1 on the
   f32 forms once a step each, the masters and Adam's slots f32 in the
   checkpoint, the first step's gradients (the initial parameters, the
   first batch) card against the CPU plain bf16 path (``_bf16_grads``:
   each tensor no farther from the CPU's f32 gradient than twice the
   CPU's bf16 one plus 1e-3 of the f32 gradient's largest entry; within
   2e-2 of the largest entry of the CPU's bf16 gradient, or, where that
   gradient itself lies farther than 2e-2 from f32, within twice the
   distance between the CPU's and a witness: the same bf16 computation
   on the card with the plain bf16 versions in place of the kernels), a
   traced step at bf16 beside one at f32; (c) the acoustic model the same way, one pass (the first layer's
   two GRUs on the bf16 forms, layers 2 and 3 and CTC on the f32 kernels);
   (d) a bf16 CUDA tensor into a kernel form with no bf16 form raises
   (flash's wide and split paths, the CRF's block forms, CTC, a cell
   with a bf16 state, the per-step routes, the optimizers); (e) the bf16
   forms of flash (D <= 128) at the seq2seq block's (50, 4, 50, 50, 128)
   with an all-padding row, (2, 4, 300, 300, 128) both ways, batch 1 and
   Tq = Tk = 8 (the ulp rule), and at [2, 4, 4096, 4096, 128] both ways
   (BF16_FLASH_LONG, timed: beside the f32 forms and SDPA at bf16), and
   of the CRF (C <= 32) at the linear
   tagger's (16, 80, 23) ragged, batch 1 and T = 3, each against its
   plain bf16 version as in (a) (the Viterbi: paths identical, scores
   bit-equal), timed at the path shapes beside the f32 forms, the plain
   versions, the bounds, SDPA at bf16 (flash) and the chain bound (CRF);
   (f) seq2seq with its self-attention block at full width (S2S_ATT) for
   4 batches x 1 pass and --job test at bf16: flash_fwd_bf16 and
   flash_bwd_bf16 once a step, the encoder's GRUs and the decoder's cell
   on their f32 kernels, the masters f32, the first step's gradients
   (``_bf16_grads``; the witness also swaps flash and the CRF for their
   plain versions); (g) the linear-CRF tagger (``_LINEAR_CRF``: 76,328
   sparse features, 23 labels) the same way: the CRF's three bf16 forms
   once a step, the trained model's decode card against CPU (partings
   counted; only where the CPU's f32 and bf16 decodes part too).
   The full run takes it after phase 11c, beside phases 8's and 11c's
   f32 step traces; ``python3 chip_smoke.py --bf16`` runs this phase
   alone (with its own f32 traces), into ``bf16.json`` in ``OUT_DIR``.
18. kernels: one JSON line ``{"kernels": [...]}`` for every ported
   kernel, with the launches of the main paths (phases 8 to 12), the
   rest of training's (phase 13) as ``training_launches``,
   DeepSpeech2 as released (phase 14) as ``ds2_release_launches``
   beside the times at its CTC shape, and phase 15's as
   ``last_types_launches`` (added to ``launches`` too), and phase 16's
   as ``serving_tier_launches`` (``lstm_seq``, ``gru_seq``,
   ``gru_cell_infer``; added to ``launches`` too). The
   backward steps of the per-step routes (``gru_bwd_step``,
   ``lstm_bwd_step``) run on no path (every path's shape is on the
   persistent route), nor do the gathered CTC kernels (``ctc_alpha_fwd``,
   ``ctc_bwd``: the layer takes the fused ones), the fused CTC kernels'
   wide and sorted routes or flash's split-row path: their entries say
   ``on_path: false`` and must show 0 launches (the gathered pair's
   wide route, ``ctc_alpha_fwd_wide`` / ``ctc_bwd_wide``, too). The ``momentum`` entry's
   ``launches`` are the classifier's training pass (phase 8); LeNet's
   and ResNet's runs of phase 12 stand beside them as ``lenet_launches``
   and ``resnet_launches``. The bf16 forms (``*_bf16``) have the
   launches of phase 17's runs.

Every ``--job`` of the CLI runs in this process (``_cli_inproc``: each
job resets the kernel counts it reports and the DSL's graph), but the
servers (phases 9, 10b, the tagger's, 16) and the killed training run of phase
13, processes of their own.
A ``phase done`` line after each phase gives its seconds and the total.
The last line is ``{"ok": true, "device": {...}}``. Full results go to
``chip_smoke.json`` in ``OUT_DIR``.

    python3 chip_smoke.py --lstm-kernels

runs only phases 3 and 4 for the LSTM at the paths' shapes (the
classifier's (64, 1280, 128) and (64, 1280, 100) and (16, 1280, 100), the
tagger's (64, 128, 80)), both routes, into ``lstm_kernels.json``.

    python3 chip_smoke.py --cell-kernels

runs only phases 5's GRU-cell part and 5b (both cells, both GRU-cell
routes, the host splits, the cluster sizes), ~30 s, into
``cell_kernels.json``.

    python3 chip_smoke.py --flash-kernels

runs only phase 7 (the flash kernels at every FLASH_SHAPES,
FLASH_WIDE_SHAPES and FLASH_SPLIT_SHAPES row with the SDPA yardstick, the
wide-head layer check, the wrappers' host split), ~1.5 min, into
``flash_kernels.json``.

    python3 chip_smoke.py --opt-kernels

runs only phase 4's optimizer part (the grouped kernels' checks at every
path's list, the per-tensor kernels at each size, each path's step update
four ways, the host split), ~1 min, into ``opt_kernels.json``.

    python3 chip_smoke.py --ds2-rate-witness

runs only the acoustic model's ``--job train`` at DeepSpeech2's own rate,
``Adam(5e-4)``, on the card and on the CPU plain path (the same batches,
seed and initial parameters; the CPU path launches no kernel) and prints
both runs' pass costs (``ds2_rate_witness.json`` in ``OUT_DIR``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import http.client
import itertools
import json
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import warnings

import numpy as np
import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.kernels import rnn_cells as C
from paddle_tpu_torch.ops import attention as ATT
from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops import crf as CRF
from paddle_tpu_torch.ops import ctc as CTC
from paddle_tpu_torch.ops import gru as G
from paddle_tpu_torch.ops import lstm as L

SOURCES = ["lstm_seq", "gru_seq", "opt_update", "crf", "flash_attn",
           "lstm_cell", "ctc", "gru_cell"]

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# published H100 SXM peaks at 700 W (NVIDIA data sheet)
F32_FLOPS = 67e12      # f32 outside the tensor cores
TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores
BF16_FLOPS = 989.4e12  # dense BF16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-5)
T_CHECK = 100
MODEL = dict(vocab_size=30000, embed_dim=128, hidden=1280, num_layers=2,
             classes=2)
MAX_BATCH = 64
TRAIN_BATCH, TRAIN_BATCHES, TRAIN_PASSES, SEQLEN = 64, 4, 3, 100
GRAD_CHECK_ROWS = 16
LENGTH_BUCKETS = [32, 64, 128]
# the shapes the serving path hands the kernel: (batch, T) at hidden 1280
SERVE_SHAPES = [(1, 32), (64, 128)]
SEED = 2017
# seq2seq_attention at the seqToseq demo's published width (wmt14 dicts of
# 30000, word vectors and encoder/decoder of 512), trained as its
# train.conf does: batch 50, Adam(5e-4)
S2S = dict(src_vocab=30000, trg_vocab=30000, embed_dim=512, hidden=512)
S2S_BATCH, S2S_BATCHES, S2S_PASSES, S2S_LEN = 50, 4, 2, 50
S2S_MIN_LEN = 10
S2S_GRAD_ROWS = 8
# GRU kernel check shapes (B, H, T): the seq2seq path's own, a longer one,
# batch 1, and the CTC acoustic model's (batch 16, 1024 units, 400 frames)
GRU_SHAPES = [(50, 512, 50), (64, 256, 100), (1, 512, 50), (16, 1024, 400)]
# above the persistent route's line (H = 1452 at batch 16 on 132 SMs):
# the two-launch route's own check
GRU_ABOVE_LINE = (16, 1536, 50)
# GRU cell check shapes (B, H): seq2seq's training and test batch, its beam
# search's 8 sources x beam 4 and one source x beam 4, batch 1
GRU_CELL_SHAPES = [(50, 512), (32, 512), (4, 512), (1, 512)]
# the cluster kernel at cluster sizes 16 and 8: at H = 512 only 16 fits
# (8 blocks would hold 384 KB of weights each), at 256 both
CLUSTER_SHAPES = [(50, 512), (50, 256)]
# beam search of the seq2seq demo's width: beam 4 (the model's default) and
# outputs of up to 50 words (the longest target trained); 8 sources decode
# as B*K = 32 rows of the step network
GEN_BEAM, GEN_MAX_LEN, GEN_SOURCES = 4, S2S_LEN, 8
GEN_MAX_BATCH = 8
GEN_EOS = 1  # the end mark of both decoders (seq2seq_attention's eos_id)
GEN_LENGTH_BUCKETS = [16, S2S_LEN]
GEN_SERVE_LENGTHS = (1, 23, 50)  # the single sources served
# LSTM cell check shapes (rows, H): the LSTM-step decoder's decode
# (B*K = 32), its training batch (50), one row
LSTM_CELL_SHAPES = [(GEN_SOURCES * GEN_BEAM, 512), (S2S_BATCH, 512),
                    (1, 512)]
# bilstm_crf_tagger at CoNLL-2000 width as rnn_crf.py hardcodes it (word
# dictionary 6778, 23 chunk labels: IOB over 11 chunk types plus O) with
# the demo config's word and hidden dims; trained as the JAX package's
# tagging test trains it, Adam(5e-3)
TAGGER = dict(vocab_size=6778, embed_dim=128, hidden=128, num_labels=23)
TAG_BATCH, TAG_BATCHES, TAG_PASSES, TAG_LEN = 64, 4, 3, 80
TAG_TEST_BATCHES = 2
TAG_MIN_LEN, TAG_MAX_LEN = 5, 78
TAG_GRAD_ROWS = 8
TAG_LENGTH_BUCKETS = [32, 80]
TAG_SERVE_LENGTHS = (1, 23, 78)  # the single sentences served
# the shapes the tagger's serving path hands the LSTM kernel, (batch, T):
# the single sentences in buckets 32 and 80, the call of 16 rows
TAG_SERVE_SHAPES = [(1, 32), (1, 80), (16, 80)]
# CRF kernel check shapes (B, T, C): the training path's, the serving
# one's, a block a sequence (C > 32), and the forward's E read from L2 (C
# = 256)
CRF_SHAPES = [(TAG_BATCH, TAG_LEN, 23), (1, TAG_LEN, 23), (16, TAG_LEN, 128),
              (16, TAG_LEN, 256)]
# above the earlier kernels' 256 classes (8 a lane of a warp), which
# crf_alpha_fwd_lanes, crf_bwd_inline and crf_viterbi_scratch refuse
CRF_BIG_SHAPES = [(4, 40, 257), (2, 20, 1000)]
CRF_EARLIER_MAX_C = 256
CRF_FLOOR_STEPS = 20000
# seq2seq_attention with its encoder self-attention block: 4 heads of 128
# over the 512-wide embedding (the JAX model's num_heads default)
S2S_ATT = dict(S2S, seq_parallel="ring", num_heads=4)
# flash-attention check shapes (B, N, Tq, Tk, D, causal, shortest kv
# length, last kv row all padding): the path's (ragged 10-50, one
# all-padding row), its batch 1, a causal cross-attention, a long
# self-attention both ways (no padding), and the two kinds of query rows
# that see no key: an all-padding kv row with Tk > 256 and Tk % 256 != 0,
# and causal with Tq > Tk
FLASH_SHAPES = [
    (S2S_BATCH, 4, S2S_LEN, S2S_LEN, 128, False, S2S_MIN_LEN, True),
    (1, 4, S2S_LEN, S2S_LEN, 128, False, S2S_MIN_LEN, False),
    (2, 4, 200, 333, 64, True, 1, False),
    (2, 4, 4096, 4096, 128, False, 4096, False),
    (2, 4, 4096, 4096, 128, True, 4096, False),
    (2, 4, 64, 333, 64, False, 1, True),
    (2, 4, 333, 200, 64, True, 1, False),
    # head widths padded (40 -> 64) or at the new instance (32)
    (50, 4, 50, 50, 32, False, S2S_MIN_LEN, True),
    (2, 4, 200, 333, 40, True, 1, False)]
# the wide-head path (128 < D <= 1024, split TF32 on the tensor cores,
# D split across a block's warps): the head
# width of multi_head_attention(size=512, num_heads=2), 256, over 300
# steps both ways with an all-padding kv row (Tk > 256, Tk % 256 != 0),
# causal with Tq > Tk, D = 160 (no padding), and the widest head, small
FLASH_WIDE_SHAPES = [
    (2, 4, 300, 300, 256, False, 1, True),
    (2, 4, 300, 300, 256, True, 1, True),
    (2, 4, 333, 200, 256, True, 1, False),
    (2, 4, 200, 333, 160, True, 1, False),
    (2, 2, 64, 64, 1024, False, 1, False)]
# the split-row path (D > 1024, a block a row): D = 1056 and 2048 at T = 64,
# causal with Tq > Tk, and an all-padding kv row
FLASH_SPLIT_SHAPES = [
    (1, 2, 64, 64, 1056, False, 1, False),
    (2, 2, 64, 64, 1056, False, 1, True),
    (1, 2, 64, 64, 2048, False, 1, False),
    (1, 2, 80, 64, 2048, True, 1, False)]
# the layer check of the wide path: multi_head_attention at size 512 with
# 2 heads (D = 256), batch 4 of 50 steps
WIDE_LAYER = dict(size=512, num_heads=2, batch=4, steps=50)
# its repeats under --flash-kernels and in the full run (each anew on the
# card and the CPU)
WIDE_LAYER_REPEATS, WIDE_LAYER_FULL_REPEATS = 20, 5
# the CTC acoustic model at DeepSpeech2's width as PaddlePaddle released
# it in 2017 (PaddlePaddle/models deep_speech_2): 161-dim linear
# spectrogram frames (20 ms window, 10 ms stride), 3 bidirectional GRU
# layers of 1024 (its --use_gru setting at the width of its Aishell
# example), an fc of dict_size + 1 = 29 (LibriSpeech's 28 English
# characters and the blank, id 28) and warp_ctc_layer(blank=28,
# norm_by_times=True), trained with Adam. Its two conv layers and batch
# norm are left out (the port has neither yet): the GRUs read the frames.
# At DS2's learning rate of 5e-4 (DS2_SOURCE_LR) the cost of this cut
# model (no batch norm) rose from pass 0 to pass 1 on the card, so the
# path trains at 2e-4; ``--ds2-rate-witness`` runs 5e-4 on the card and
# on the CPU plain path. Batches are synthetic: 16 utterances of 100-400
# frames (1-4 s;
# DS2 trains utterances up to 27 s, cut here to keep the three passes
# and the CPU gradient reference within the script's time), T/10-T/6
# characters each, so labels pad to 66 and S = 2 L + 1 <= 133
DS2 = dict(features=161, hidden=1024, layers=3, chars=28)
DS2_BATCH, DS2_BATCHES, DS2_PASSES = 16, 4, 3
DS2_MIN_T, DS2_MAX_T = 100, 400
DS2_LABEL_PAD = DS2_MAX_T // 6
DS2_GRAD_ROWS = 4
DS2_LR = 2e-4
DS2_SOURCE_LR = 5e-4
# DeepSpeech2 as released (``_DS2R_MODEL``, phase 14) at full width: the
# 161 x 400 spectrogram, 32 filters of 11 x 41 (stride 3 x 2, padding 5 x
# 20) and 11 x 21 (1 x 2, 5 x 10), 41 rows into block_expand (134 steps
# of 1312), 3 bidirectional layers of 1024, 28 characters and the blank
DS2R = dict(height=DS2["features"], width=DS2_MAX_T, chars=DS2["chars"],
            filters=32, hidden=DS2["hidden"], layers=DS2["layers"],
            convs=[(11, 41, 3, 2, 5, 20), (11, 21, 1, 2, 5, 10)])
DS2R_STEPS = DS2_MAX_T  # the time columns after the convs: 134
for _fx, _, _sx, _, _px, _ in DS2R["convs"]:
    DS2R_STEPS = (DS2R_STEPS + 2 * _px - _fx) // _sx + 1
DS2R_PASSES, DS2R_RNN_PASSES = 2, 1
DS2R_TEST_BATCHES = 1  # --job test, card and CPU (the CPU's takes most)
# CTC kernel check shapes (B, T, L): the acoustic model's (with an empty
# transcript, an infeasible row, repeated labels, padded frame tails), its
# batch 1, utterances of LibriSpeech's length (16 s, up to 240
# characters: S = 481), and DeepSpeech2 as released's 134 frames after
# its convolutions (phase 14)
CTC_SHAPES = [(DS2_BATCH, DS2_MAX_T, DS2_LABEL_PAD), (1, DS2_MAX_T,
                                                     DS2_LABEL_PAD),
              (DS2_BATCH, 1600, 240),
              (DS2_BATCH, DS2R_STEPS, DS2_LABEL_PAD)]
# sizes the fused kernels refused before they took any S and C (B, T, C,
# L): 60,000 classes (the staged posterior pass's class offsets no longer
# fit a block: the sorted pass) and 20,001 states (above the lanes'
# 16,384: the wide chains), each with a full row and a padded one
CTC_BEYOND_SHAPES = [(2, 50, 60000, 10), (1, 10500, 29, 10000)]
# the gathered form above the lanes' 16,384 states (B, T, C, L): S =
# 16,385 and 20,001, transcripts of T/4 to T/2 characters
CTC_GATHERED_BEYOND = [(1, 2000, 29, 8192), (1, 2000, 29, 10000)]
# the image slice: ResNet-50 as __graft_entry__.py:entry() builds it
# (resnet(50, classes=1000, image_size=224), an NHWC feed [8, 224, 224, 3])
# at full width and depth; its gradients at batch 2; LeNet (lenet_mnist)
# trained through the CLI on synthetic 28 x 28 digits (each class a fixed
# random prototype plus noise, from SEED)
RESNET = dict(depth=50, classes=1000, image_size=224)
RESNET_BATCH, RESNET_GRAD_BATCH, RESNET_REPS = 8, 2, 5
LENET_BATCH, LENET_BATCHES, LENET_PASSES = 64, 4, 3
LENET_SERVE_BATCH = 16


def phase(title: str, **kv):
    print(f"phase {title}: {json.dumps(kv)}", flush=True)


# ------------------------------------------------------------ 1. device
def check_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); this script runs on the "
                         "card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products summed in f32, as JAX's bf16 dots are
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


# ------------------------------------------------------------- 2. build
def build_kernels():
    secs = build.build_all(SOURCES)
    report = {}
    for name in SOURCES:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            report[name] = [ln.strip() for ln in log.read_text().splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln]
    phase("build", seconds=secs, ptxas=report)


# ------------------------------------------------------ 3. kernel check
def _inputs(B, H, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev)
    lens[0] = T
    mask = (torch.arange(T, device=dev)[:, None] < lens[None, :]).float()
    return dict(xs=randn(T, B, 4 * H), mask=mask.contiguous(),
                w=randn(H, 4 * H, scale=H ** -0.5),
                bias=randn(4 * H, scale=0.1), pI=randn(H, scale=0.1),
                pF=randn(H, scale=0.1), pO=randn(H, scale=0.1),
                h0=randn(B, H, scale=0.5), c0=randn(B, H, scale=0.5))


def _plain(a, reverse):
    xs, mask = a["xs"], a["mask"]
    if reverse:
        xs, mask = xs.flip(0), mask.flip(0)
    ys, hT, cT = L.lstm_sequence_plain(xs + a["bias"], mask, a["w"],
                                       a["pI"], a["pF"], a["pO"], a["h0"],
                                       a["c0"])
    return (ys.flip(0) if reverse else ys), hT, cT


def _time_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, kernel, calls=20, per_call=1):
    """Device time of one call of ``fn``: the CUDA kernels whose names
    contain ``kernel`` (or one of a tuple of names; each launched
    ``per_call`` times per call), from
    ``torch.profiler`` over ``calls`` calls after one warm call and a
    warm-up cycle (``_traced``): for a
    kernel shorter than its wrapper's host work, where CUDA events around
    the call measure the host. Each kernel's time is its mean over the
    launches the trace holds, times ``per_call``; a trace that holds fewer
    than half of them (the profiler here drops launches now and then, and
    now and then a whole trace: then after a pause) is taken again, up to
    six times. ``kernel=None``: every CUDA kernel of
    the calls, summed and divided by ``calls``. Returns (ms, record): the
    record holds ``calls`` and each trace's [launches, mean ms a launch]
    by kernel name, so that a trace with dropped launches shows beside the
    time."""
    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    traces = []
    for _ in range(6):
        if traces and not traces[-1]:
            time.sleep(0.5)
        found = [e for e in _traced(fn, calls)[0]
                 if names is None or any(n in e.key for n in names)]
        traces.append({e.key: [e.count, 1e-3 * e.self_device_time_total
                               / max(e.count, 1)] for e in found})
        record = dict(calls=calls, traces=traces)
        if found and names is None:
            return 1e-3 * sum(e.self_device_time_total
                              for e in found) / calls, record
        if found and all(calls * per_call // 2 <= e.count
                         <= calls * per_call for e in found):
            return 1e-3 * per_call * sum(e.self_device_time_total / e.count
                                         for e in found), record
    raise AssertionError(f"profiler found {traces} for {kernel} in six "
                         "traces")


def _traced(fn, calls):
    """``torch.profiler`` over ``calls`` calls of ``fn``, after a warm-up
    cycle of as many calls under the profiler, which it does not keep (the
    profiler drops launches at the start of a trace): the device events
    of the traced calls by kernel (``key_averages``, without the
    profiler's own step annotation) and their wall ms to a
    synchronise."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            prof.step()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")], wall_ms


def _bound(ops, nbytes):
    """Least time for the work, ms: the bytes (each input read once, each
    output written once) over HBM, or the operations at the f32 rate,
    whichever is larger; and which one it is."""
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound_ms(B, H, T, residuals=False):
    """The recurrence: its product 2*B*H*4H per step; xs, mask, W, the
    peepholes, h0, c0 in, ys and hT, cT (or the residuals hs, cs and
    gates) out."""
    outs = (3 * T * B * H + T * B * 4 * H) if residuals \
        else (T * B * H + 2 * B * H)
    return _bound(2.0 * B * H * 4 * H * T,
                  4 * (T * B * 4 * H + T * B + H * 4 * H + 3 * H
                       + 2 * B * H + outs))


def _lstm_routes(B, H, x):
    """The routes a shape has: the persistent one where ``lstm_route``
    takes it (and the per-step one, forced, beside it), else the per-step
    one alone; as ``per_step`` flags."""
    route = L.lstm_route(B, H, L.device_sms(x))
    return route, ((False, True) if route == L.PERSISTENT else (True,))


def _fwd_kernel(per_step, T):
    """The forward's kernel name and its launches per call on a route."""
    return (("lstm_step_kernel",), T) if per_step else \
        (("lstm_persistent_kernel",), 1)


def check_shape(B, H, T, senses, seed):
    """The primal kernel at one shape on each route the shape has: ys,
    hT, cT in both directions against the plain loop; CUDA-event and
    ``torch.profiler`` device times of each route (the forced per-step
    route's keys prefixed ``per_step_`` where the shape is persistent),
    the plain loop's time and the bound."""
    a = _inputs(B, H, T, seed)
    route, routes = _lstm_routes(B, H, a["xs"])
    xs_b = (a["xs"] + a["bias"]).contiguous()
    args = (xs_b, a["mask"], a["w"], a["pI"], a["pF"], a["pO"], a["h0"],
            a["c0"])
    row = dict(B=B, H=H, T=T, route=route)
    err = 0.0
    calls = 10 if T >= 80 else 20
    for per_step in routes:
        for reverse in senses:
            got = L.lstm_sequence(a["xs"], a["mask"], a["w"], a["bias"],
                                  a["pI"], a["pF"], a["pO"], a["h0"],
                                  a["c0"], reverse=reverse,
                                  per_step=per_step)
            torch.cuda.synchronize()
            want = _plain(a, reverse)
            for name, g, w in zip(("ys", "hT", "cT"), got, want):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"B={B} H={H} reverse={reverse}: "
                                         f"{name} is not finite")
                err = max(err, (g - w).abs().max().item())
                torch.testing.assert_close(
                    g, w, **TOL, msg=lambda m: f"B={B} H={H} T={T} reverse="
                    f"{reverse} per_step={per_step} {name}: {m}")
        p = "per_step_" if per_step and route == L.PERSISTENT else ""
        run = lambda: L.lstm_seq(*args, per_step=per_step)
        row[p + "ms"] = _time_ms(run)
        kernel, per = _fwd_kernel(per_step, T)
        row[p + "device_ms"] = _device_ms(run, kernel, calls, per)[0]
    row["max_abs_err"] = err
    row["plain_ms"] = _time_ms(lambda: L.lstm_sequence_plain(*args))
    row["bound_ms"], row["bound_by"] = _bound_ms(B, H, T)
    if route == L.PERSISTENT:
        for key in ("ms", "device_ms"):
            row["speedup_" + key] = row["per_step_" + key] / row[key]
    phase("kernel_check", **row)
    return row


def check_kernels():
    rows = [check_shape(B, H, T_CHECK, (False, True), seed=B * 7 + H)
            for B, H in L.BENCH_SHAPES]
    serve_rows = [check_shape(B, MODEL["hidden"], T, (False,), seed=B + T)
                  for B, T in SERVE_SHAPES]
    return rows, serve_rows


# ------------------------------------------------ 4. train kernel check
def _grad_err(got, want):
    """max |got - want| and the per-tensor limit 1e-4 * max|want| + 1e-5."""
    return ((got - want).abs().max().item(),
            1e-4 * want.abs().max().item() + 1e-5)


def _check_grads(where, got, want, names):
    err = 0.0
    for name, g, w in zip(names, got, want):
        e, limit = _grad_err(g, w)
        if not (e <= limit):
            raise AssertionError(f"{where} d{name}: max abs err {e} > "
                                 f"{limit}")
        err = max(err, e)
    return err


def _residual_args(a):
    return ((a["xs"] + a["bias"]).contiguous(), a["mask"], a["w"], a["pI"],
            a["pF"], a["pO"], a["h0"], a["c0"])


def _cotangents(B, H, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda")
            for shape in ((T, B, H), (B, H), (B, H))]


def _bwd_step_args(res, cot):
    """One reverse step's arguments (the last step of the sequence)."""
    mask, w, pI, pF, pO, h0, c0, hs, cs, gates = res
    dys, dhT, dcT = cot
    return (dys[-1], mask[-1], gates[-1], cs[-1], cs[-2], pI, pF, pO,
            torch.zeros_like(dhT), dhT.clone(), dcT.clone(),
            torch.empty_like(gates[-1]))


def _chain_bound_ms(B, H, T):
    """The backward's reverse chain: its product 2*B*4H*H per step; dys,
    mask, gates, cs, c0, W, the peepholes, dhT, dcT in; dxs, dh0, dc0
    out."""
    return _bound(2.0 * B * 4 * H * H * T,
                  4 * (T * B * H + T * B + 4 * T * B * H + T * B * H + B * H
                       + 4 * H * H + 3 * H + 2 * B * H + 4 * T * B * H
                       + 2 * B * H))


def check_train_shape(B, H, T, seed):
    """The residual forward and the whole backward at one shape on each
    route it has (as ``check_shape``): against the plain residual loop and
    the backward with the plain step (two chain runs bit-equal); times of
    each route (CUDA events; ``torch.profiler`` device time of the
    forward's kernel and of every kernel of the backward); on the
    persistent route the chain alone beside the per-step route's loop
    alone; one backward step; the plain versions; the bounds."""
    a = _inputs(B, H, T, seed)
    args = _residual_args(a)
    route, routes = _lstm_routes(B, H, a["xs"])
    want = L.lstm_sequence_residual_plain(*args)
    cot = _cotangents(B, H, T, seed + 1)
    row = dict(B=B, H=H, T=T, route=route, fwd_max_abs_err=0.0,
               bwd_max_abs_err=0.0)
    calls = 10 if T >= 80 else 20
    names = ("xs", "W", "pI", "pF", "pO", "h0", "c0")
    for per_step in routes:
        where = f"B={B} H={H} T={T} per_step={per_step}"
        got = L.lstm_seq_train(*args, per_step=per_step)
        torch.cuda.synchronize()
        for name, g, w in zip(("ys", "hs", "cs", "gates"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{where}: {name} is not finite")
            row["fwd_max_abs_err"] = max(row["fwd_max_abs_err"],
                                         (g - w).abs().max().item())
            torch.testing.assert_close(
                g, w, **TOL, msg=lambda m: f"{where} {name}: {m}")
        res = (a["mask"], a["w"], a["pI"], a["pF"], a["pO"], a["h0"],
               a["c0"], *got[1:])
        got_b = L.lstm_backward(*res, *cot, per_step=per_step)
        torch.cuda.synchronize()
        want_b = L.lstm_backward(*res, *cot, step=L.lstm_bwd_step_plain)
        row["bwd_max_abs_err"] = max(row["bwd_max_abs_err"], _check_grads(
            f"{where} backward", got_b, want_b, names))
        if not per_step:
            for name, g, g2 in zip(names, got_b,
                                   L.lstm_backward(*res, *cot)):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{where}: two chain runs differ "
                                         f"in d{name}")
        p = "per_step_" if per_step and route == L.PERSISTENT else ""
        fwd = lambda: L.lstm_seq_train(*args, per_step=per_step)
        bwd = lambda: L.lstm_backward(*res, *cot, per_step=per_step)
        row[p + "fwd_ms"] = _time_ms(fwd)
        kernel, per = _fwd_kernel(per_step, T)
        row[p + "fwd_device_ms"] = _device_ms(fwd, kernel, calls, per)[0]
        row[p + "bwd_ms"] = _time_ms(bwd)
        # every kernel of the backward: the chain or the per-step kernels
        # and their cuBLAS products, then dW and the peephole sums
        row[p + "bwd_device_ms"] = _device_ms(bwd, None, calls)[0]
    mask, w, pI, pF, pO, h0, c0, hs, cs, gates = res
    dys, dhT, dcT = cot
    chain_args = (dys, mask, gates, cs, c0, w, pI, pF, pO, dhT, dcT)

    def step_loop():  # the per-step route's reverse chain, no dW
        dh, dc, dhw = dhT.clone(), dcT.clone(), torch.zeros_like(dhT)
        dxs = torch.empty_like(gates)
        for t in range(T - 1, -1, -1):
            L.lstm_bwd_step(dys[t], mask[t], gates[t], cs[t],
                            cs[t - 1] if t else c0, pI, pF, pO, dhw, dh, dc,
                            dxs[t])
            torch.matmul(dxs[t], w.t(), out=dhw)

    row["step_loop_ms"] = _time_ms(step_loop)
    if route == L.PERSISTENT:
        chain = lambda: L.lstm_bwd_chain(*chain_args)
        row["chain_ms"] = _time_ms(chain)
        row["chain_device_ms"] = _device_ms(chain, "lstm_bwd_chain_kernel",
                                            calls)[0]
        row["chain_plain_ms"] = _time_ms(
            lambda: L.lstm_bwd_chain_plain(*chain_args))
        row["speedup_chain_vs_step_loop"] = row["step_loop_ms"] / \
            row["chain_ms"]
        for key in ("fwd_ms", "fwd_device_ms", "bwd_ms", "bwd_device_ms"):
            row["speedup_" + key] = row["per_step_" + key] / row[key]
    step = _bwd_step_args(res, cot)
    row.update(
        fwd_plain_ms=_time_ms(lambda: L.lstm_sequence_residual_plain(*args)),
        bwd_plain_ms=_time_ms(lambda: L.lstm_backward(
            *res, *cot, step=L.lstm_bwd_step_plain)),
        step_ms=_time_ms(lambda: L.lstm_bwd_step(*step), reps=50),
        step_plain_ms=_time_ms(lambda: L.lstm_bwd_step_plain(*step),
                               reps=50))
    row["fwd_bound_ms"], row["fwd_bound_by"] = _bound_ms(B, H, T, True)
    row["chain_bound_ms"], row["chain_bound_by"] = _chain_bound_ms(B, H, T)
    # one backward step: dy, mask, gates, c_new, c_prev, peepholes, dhw,
    # dh, dc in; dh, dc, dgates out; ~37 operations per element
    row["step_bound_ms"], row["step_bound_by"] = _bound(
        37.0 * B * H, 4 * (15 * B * H + B + 3 * H))
    phase("train_kernel_check", **row)
    return row


def check_reverse(B, H, T, seed):
    """reverse=True through LstmFunction (flip in, flip out; the bias
    folded outside) against the plain residual forward and backward."""
    a = _inputs(B, H, T, seed)
    names = ("xs", "w", "bias", "pI", "pF", "pO", "h0", "c0")
    leaves = {k: a[k].clone().requires_grad_(True) for k in names}
    ys, hT, cT = L.lstm_sequence(
        leaves["xs"], a["mask"], leaves["w"], leaves["bias"], leaves["pI"],
        leaves["pF"], leaves["pO"], leaves["h0"], leaves["c0"], reverse=True)
    dys, dhT, dcT = _cotangents(B, H, T, seed + 1)
    got = torch.autograd.grad(
        (ys * dys).sum() + (hT * dhT).sum() + (cT * dcT).sum(),
        [leaves[k] for k in names])
    torch.cuda.synchronize()
    f = dict(a, xs=a["xs"].flip(0), mask=a["mask"].flip(0).contiguous())
    args = _residual_args(f)
    w_ys, hs, cs, gates = L.lstm_sequence_residual_plain(*args)
    dxs, dW, dpI, dpF, dpO, dh0, dc0 = L.lstm_backward(
        f["mask"], a["w"], a["pI"], a["pF"], a["pO"], a["h0"], a["c0"], hs,
        cs, gates, dys.flip(0), dhT, dcT, step=L.lstm_bwd_step_plain)
    want = (dxs.flip(0), dW, dxs.sum(dim=(0, 1)), dpI, dpF, dpO, dh0, dc0)
    torch.testing.assert_close(ys, w_ys.flip(0), **TOL)
    err = _check_grads(f"reverse B={B} H={H}", got, want, names)
    phase("train_kernel_check_reverse", B=B, H=H, T=T, max_abs_err=err)
    return err


def path_param_shapes():
    """{path: [shape of each parameter it trains]} of every path that
    trains with an optimizer on the card: the h=1280 LSTM classifier, the
    full-width seq2seq model with and without its self-attention block, the
    CoNLL-2000-width tagger, the DeepSpeech2-width acoustic model and the
    ``lstm_step`` decoder (static parameters, which take no update, left
    out)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    from paddle_tpu_torch.models.tagging import bilstm_crf_tagger

    def acoustic():
        ns, d = _ds2_ns()
        return ns["acoustic_model"](d)

    out = {}
    for path, build_model in (
            ("classifier", lambda: lstm_text_classifier(**MODEL)),
            ("seq2seq", lambda: seq2seq_attention(**S2S)),
            ("seq2seq_attention", lambda: seq2seq_attention(**S2S_ATT)),
            ("tagger", lambda: bilstm_crf_tagger(**TAGGER)),
            ("acoustic", acoustic),
            ("lstm_decoder", lambda: (_lstm_decoder(),))):
        dsl.reset()
        cost = build_model()[0]
        specs = Network(dsl.current_graph(), outputs=[cost.name]).param_specs
        out[path] = [tuple(s.shape) for s in specs.values()
                     if not s.is_static]
    return out


# Adam's step in the optimizer checks; bytes an element moves (p, g and
# the slots read, p and the slots written)
OPT_T = 3
OPT_BYTES = {"adam": 28, "momentum": 20}


def _opt_list(shapes, seed, offset=0, varied=True):
    """A list of updates for ``apply_group`` on the card, (p, g, {"mom",
    "v"}, lr, decay) a parameter: random values, v >= 0; with ``varied``
    each tensor's own lr and decay (the per-parameter rates and l2
    overrides the table carries), else 2e-3 and 1e-3 throughout; with
    ``offset`` every tensor a view at that storage offset."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape):
        n = int(np.prod(shape))
        return torch.randn(n + offset, generator=g, device="cuda")[
            offset:].view(shape)

    out = []
    for i, shape in enumerate(shapes):
        p, grad, m, v = (make(shape) for _ in range(4))
        lr, decay = ((2e-3 * (1 + i % 3), 1e-3 * (i % 2)) if varied
                     else (2e-3, 1e-3))
        out.append((p, grad, {"mom": m, "v": v.abs_()}, lr, decay))
    return out


def _as_kind(entries, kind):
    """The list for ``kind``: Momentum's updates carry {"mom"} only."""
    if kind == "adam":
        return entries
    return [(p, g, {"mom": s["mom"]}, lr, d) for p, g, s, lr, d in entries]


@functools.lru_cache(maxsize=None)
def _opt(kind):
    """The optimizer of the checks: Adam(2e-3) or Momentum(0.9)."""
    from paddle_tpu_torch.optim import Adam, Momentum
    return (Adam(learning_rate=2e-3) if kind == "adam"
            else Momentum(momentum=0.9))


def _group_check(kind, entries, where):
    """``apply_group`` against ``_apply_one`` per tensor on the same card
    tensors: every output bit-equal (max abs error 0), the inputs
    unchanged, one launch per table. Returns the max abs error."""
    from paddle_tpu_torch.kernels import opt_update
    opt = _opt(kind)
    counter = getattr(opt_update, kind)
    before = [(p.clone(), g.clone(), {k: v.clone() for k, v in s.items()})
              for p, g, s, _, _ in entries]
    n0 = counter.launches
    got = opt_update.apply_group(opt, entries, OPT_T)
    launches = counter.launches - n0
    tables = -(-len(entries) // opt_update.table_capacity())
    if launches != tables:
        raise AssertionError(f"{kind} {where}: {launches} launches for "
                             f"{len(entries)} tensors ({tables} tables)")
    err = 0.0
    for i, ((p, g, s, lr, d), (p2, s2)) in enumerate(zip(entries, got)):
        want_p, want_s = opt._apply_one(p, g, s, lr, d, OPT_T)
        for name, a, b in [("p", p2, want_p)] + [(k, s2[k], want_s[k])
                                                 for k in want_s]:
            err = max(err, (a - b).abs().max().item())
            if not torch.equal(a, b):
                raise AssertionError(f"{kind} {where}: tensor {i} {name} "
                                     "differs from _apply_one")
    for i, ((p, g, s, _, _), (p0, g0, s0)) in enumerate(zip(entries,
                                                           before)):
        if not (torch.equal(p, p0) and torch.equal(g, g0) and all(
                torch.equal(s[k], s0[k]) for k in s)):
            raise AssertionError(f"{kind} {where}: input {i} changed")
    return err


@functools.lru_cache(maxsize=None)
def _per_tensor_entry(kind):
    """The per-tensor C entry (``momentum_update``,
    ``adam_update``), which no path calls since the grouped kernels."""
    import ctypes
    fn = getattr(build.load("opt_update"), f"{kind}_update")
    n_ptr, n_f = (7, 7) if kind == "adam" else (5, 3)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_f
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _per_tensor_update(kind, p, g, slots, lr, decay):
    """One tensor's update through the per-tensor wrapper spelling (the
    checks, three ``empty_like``, a ``torch.cuda.device`` guard,
    ``current_stream``, ``data_ptr`` and the per-tensor entry): the
    "before" of the grouped launch, uncounted."""
    from paddle_tpu_torch.kernels import opt_update
    opt = _opt(kind)
    ins = [p, g, slots["mom"]] + ([slots["v"]] if kind == "adam" else [])
    opt_update._check(kind, ins)
    outs = [torch.empty_like(p) for _ in range(len(ins) - 1)]
    scalars = ((opt.alpha(lr, OPT_T), decay, opt.beta1, 1 - opt.beta1,
                opt.beta2, 1 - opt.beta2, opt.epsilon) if kind == "adam"
               else (lr, decay, opt.momentum))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _per_tensor_entry(kind)(
            *(t.data_ptr() for t in ins + outs), *scalars, p.numel(), stream)
    build.raise_on(err, kind)
    return outs


def _per_tensor_check(kind, p, g, slots, lr, decay, where):
    """The per-tensor kernel against ``_apply_one`` on the same card
    tensors: every output bit-equal. Returns the max abs error."""
    got = _per_tensor_update(kind, p, g, slots, lr, decay)
    want_p, want_s = _opt(kind)._apply_one(p, g, slots, lr, decay, OPT_T)
    err = 0.0
    for name, a, b in zip(("p", *want_s), got, (want_p, *want_s.values())):
        err = max(err, (a - b).abs().max().item())
        if not torch.equal(a, b):
            raise AssertionError(f"per-tensor {kind} {where}: {name} "
                                 "differs from _apply_one")
    return err


def _per_size_rows(sizes):
    """The per-tensor kernels at each size: bit-equal to ``_apply_one``
    (aligned; and at storage offset 1, scalar moves, at 1, 7 and 1025
    and the largest size), CUDA events around the wrapper call (median
    of 10) and device time (``torch.profiler``) of both, beside their
    bytes bounds. Returns (rows, max abs error by kind)."""
    rows, err = [], {"adam": 0.0, "momentum": 0.0}
    for n in sorted(set(sizes) | {1, 7, 1025}):
        (p, g, s, lr, d), = _opt_list([(n,)], n, varied=False)
        views = [(p, g, s, lr, d)]
        if n in (1, 7, 1025, max(sizes)):
            views += _opt_list([(n,)], n + 1, offset=1)
        row = dict(n=n)
        for kind in ("adam", "momentum"):
            for e in _as_kind(views, kind):
                err[kind] = max(err[kind], _per_tensor_check(
                    kind, *e, f"n={n} offset={e[0].storage_offset()}"))
            sl = s if kind == "adam" else {"mom": s["mom"]}
            run = functools.partial(_per_tensor_update, kind, p, g, sl, lr, d)
            row[f"{kind}_ms"] = _time_ms(run)
            row[f"{kind}_bound_ms"] = 1e3 * OPT_BYTES[kind] * n / \
                HBM_BYTES_PER_S
            row[f"{kind}_device_ms"] = _device_reading(
                row, f"{kind}_device_ms", _device_ms(
                    run, f"{kind}_kernel", calls=10)[0],
                row[f"{kind}_bound_ms"], OPT_BYTES[kind] * n)
        rows.append(row)
        phase("optimizer_per_size", **row)
    phase("optimizer_per_tensor_check", max_abs_err=err)
    return rows, err


# the H100's L2: a list whose bytes exceed it streams from HBM every call
L2_BYTES = 50 * 2 ** 20


def _device_reading(row, key, ms, bound_ms, nbytes):
    """``ms``, or None where it lies below the bytes bound of work larger
    than the L2 (no card does that: a trace that lost launches), the
    refused reading then kept in ``row`` under ``key + "_refused"``."""
    if nbytes > L2_BYTES and ms < bound_ms:
        row[key + "_refused"] = ms
        return None
    return ms


def _back_to_back_ms(fn, calls=100):
    """CUDA events around ``calls`` calls of ``fn`` back to back, over
    ``calls``: the device's time a call wherever the call's host path is
    shorter than its device work (the queue never drains), else the
    host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _fused_adam_args(entries):
    """``torch._fused_adam_`` over clones of the list, with Paddle's
    update: eps / sqrt(1 - b2^t) (torch divides sqrt(v) by sqrt(1 - b2^t)
    before it adds eps), the steps at t already taken. The list's lr and
    decay are one each."""
    opt = _opt("adam")
    lr, decay = entries[0][3], entries[0][4]
    ps = [e[0].clone() for e in entries]
    gs = [e[1] for e in entries]
    ms = [e[2]["mom"].clone() for e in entries]
    vs = [e[2]["v"].clone() for e in entries]
    steps = [torch.full((), float(OPT_T), device="cuda") for _ in entries]
    eps = opt.epsilon / float(np.sqrt(1 - opt.beta2 ** OPT_T))
    return (ps, gs, ms, vs, [], steps), dict(
        lr=lr, beta1=opt.beta1, beta2=opt.beta2, weight_decay=decay,
        eps=eps, amsgrad=False, maximize=False)


def _path_step_row(path, shapes, seed):
    """One path's whole step update at its parameter list: the
    per-tensor loop, the grouped launch, the plain ``_apply_one`` loop
    and (Adam) ``torch._fused_adam_``, by CUDA events around one call
    (median of 10) and over 100 calls back to back
    (``_back_to_back_ms``), and the port's two by device time
    (``torch.profiler`` at their known launches a call), beside the bytes
    bound."""
    from paddle_tpu_torch.kernels import opt_update
    entries = _opt_list(shapes, seed, varied=False)
    n = sum(int(np.prod(sh)) for sh in shapes)
    row = dict(path=path, tensors=len(shapes), elements=n)
    for kind in ("adam", "momentum"):
        opt, lst = _opt(kind), _as_kind(entries, kind)
        ways = dict(
            per_tensor=lambda: [_per_tensor_update(kind, *e) for e in lst],
            grouped=lambda: opt_update.apply_group(opt, lst, OPT_T),
            plain=lambda: [opt._apply_one(*e, OPT_T) for e in lst])
        tables = -(-len(lst) // opt_update.table_capacity())
        counts = dict(per_tensor=(f"{kind}_kernel<", len(lst)),
                      grouped=(f"{kind}_multi_kernel", tables))
        bound = row[f"{kind}_bound_ms"] = 1e3 * OPT_BYTES[kind] * n / \
            HBM_BYTES_PER_S
        if kind == "adam":
            args, kw = _fused_adam_args(lst)
            ways["library"] = lambda: torch._fused_adam_(*args, **kw)
            torch._fused_adam_(*args, **kw)
            got = opt_update.apply_group(opt, lst, OPT_T)
            row["library_max_abs_diff"] = max(
                (a - b[0]).abs().max().item() for a, b in zip(args[0], got))
        for way, fn in ways.items():
            key = f"{kind}_{way}"
            row[f"{key}_ms"] = _time_ms(fn)
            if way == "plain":
                continue
            row[f"{key}_b2b_ms"] = _device_reading(
                row, f"{key}_b2b_ms", _back_to_back_ms(fn), bound,
                OPT_BYTES[kind] * n)
            if way in counts:
                frag, per_call = counts[way]
                row[f"{key}_device_ms"] = _device_reading(
                    row, f"{key}_device_ms", _device_ms(
                        fn, frag, calls=10, per_call=per_call)[0], bound,
                    OPT_BYTES[kind] * n)
    phase("optimizer_path_step", **row)
    return row


def _opt_host_split(path, shapes, seed):
    """The host split (``_split_us``: median of 5 interleaved rounds of
    400 calls) of the grouped Adam call at one path's list: the routing
    and checks, the allocation of the outputs (three ``empty_like`` a
    tensor), the launch (the pointers, the arrays, the C entry's tables
    and launch), all after the routing, the whole call; beside the
    per-tensor loop and ``torch._fused_adam_`` (in place: no
    allocation)."""
    from paddle_tpu_torch.kernels import opt_update
    opt = _opt("adam")
    entries = _opt_list(shapes, seed, varied=False)
    ins = opt_update.route(opt, entries)[2]
    lrs, decays = [e[3] for e in entries], [e[4] for e in entries]
    rates = [opt.alpha(lr, OPT_T) for lr in lrs]
    outs = opt_update.group_outputs(ins)
    args, kw = _fused_adam_args(entries)
    got = _split_us(dict(grouped=(False, dict(
        route=lambda: opt_update.route(opt, entries),
        alloc=lambda: opt_update.group_outputs(ins),
        launch=lambda: opt_update.launch(opt, "adam", ins, outs, rates,
                                         decays),
        launch_group=lambda: opt_update._launch_group(
            opt, "adam", ins, lrs, decays, OPT_T),
        whole=lambda: opt_update.apply_group(opt, entries, OPT_T))),
        per_tensor=(False, dict(whole=lambda: [
            _per_tensor_update("adam", *e) for e in entries])),
        library=(False, dict(whole=functools.partial(
            torch._fused_adam_, *args, **kw)))))
    row = dict(path=path, tensors=len(shapes),
               host_us=got["grouped"],
               host_us_per_tensor_loop=got["per_tensor"]["whole"],
               host_us_library=got["library"]["whole"])
    phase("optimizer_host_split", **row)
    return row


def check_optimizer_kernels():
    """Phase 4's optimizer part. The grouped Momentum and Adam kernels
    against ``_apply_one`` per tensor on the same card tensors (max abs
    error 0, the inputs unchanged, one launch per table) at every path's
    parameter list with per-tensor lr and decay (Adam at t = 3), at a list
    of misaligned views (storage offset 1: scalar moves) and at a list of
    1000 tensors (three tables); the table's capacity as the kernel
    counts it. The per-tensor kernels timed at every size of those
    lists; each path's whole step update timed four ways (per-tensor,
    grouped, ``torch._fused_adam_`` for Adam, the bytes bound); the host
    split of the grouped call at the tagger's and the acoustic model's
    lists."""
    from paddle_tpu_torch.kernels import opt_update
    cap = opt_update.table_capacity()
    lists = path_param_shapes()
    err = {"adam": 0.0, "momentum": 0.0}
    rng = np.random.default_rng(SEED)
    checks = dict(lists, misaligned=lists["tagger"] + [(7,), (1,), (1025,)],
                  overflow=[(int(n),) for n in rng.integers(1, 5000,
                                                            size=1000)])
    for i, (where, shapes) in enumerate(checks.items()):
        entries = _opt_list(shapes, SEED + i,
                            offset=1 if where == "misaligned" else 0)
        for kind in err:
            err[kind] = max(err[kind], _group_check(
                kind, _as_kind(entries, kind), where))
        del entries
        phase("optimizer_group_check", list=where, tensors=len(shapes),
              elements=sum(int(np.prod(sh)) for sh in shapes),
              max_abs_err=err)
    sizes = sorted({int(np.prod(sh)) for sh in itertools.chain(
        *lists.values())})
    per_size, per_tensor_err = _per_size_rows(sizes)
    paths = [_path_step_row(path, shapes, SEED + 50 + i)
             for i, (path, shapes) in enumerate(lists.items())]
    split = [_opt_host_split(path, lists[path], SEED + 70)
             for path in ("tagger", "acoustic")]
    rows = {}
    for kind, path in (("adam", "acoustic"), ("momentum", "classifier")):
        r = next(x for x in paths if x["path"] == path)
        rows[kind] = dict(
            path=path, tensors=r["tensors"], elements=r["elements"],
            max_abs_err=err[kind], table_capacity=cap,
            ms=r[f"{kind}_grouped_ms"],
            device_ms=r[f"{kind}_grouped_device_ms"],
            b2b_ms=r[f"{kind}_grouped_b2b_ms"],
            per_tensor_ms=r[f"{kind}_per_tensor_ms"],
            per_tensor_device_ms=r[f"{kind}_per_tensor_device_ms"],
            per_tensor_max_abs_err=per_tensor_err[kind],
            plain_ms=r[f"{kind}_plain_ms"], bound_ms=r[f"{kind}_bound_ms"],
            bound_by="bytes", library_ms=r.get(f"{kind}_library_ms"),
            library_b2b_ms=r.get(f"{kind}_library_b2b_ms"))
        phase("optimizer_kernel_check", kind=kind, **rows[kind])
    return dict(rows, per_size=per_size, paths=paths, host_split=split,
                sizes=sizes)


def opt_kernels():
    """``--opt-kernels``: phase 4's optimizer part alone; rows in
    ``opt_kernels.json`` in ``OUT_DIR``."""
    build.build_all(["opt_update"])
    out = check_optimizer_kernels()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "opt_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)


def check_train_kernels():
    rows = [check_train_shape(B, H, T_CHECK, seed=B * 11 + H)
            for B, H in L.BENCH_SHAPES]
    reverse_err = check_reverse(64, MODEL["hidden"], T_CHECK, seed=5)
    return rows, reverse_err, check_optimizer_kernels()


# --------------------------------------------------- 5. GRU kernel check
def _gru_inputs(B, H, T, seed):
    """xs [T,B,3H], a ragged mask, bias, h0, and the two column slices of
    one w0 [H,3H]: non-contiguous views, as the layers pass them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    lens[0] = T
    mask = (torch.arange(T, device="cuda")[:, None] < lens[None, :]).float()
    w0 = randn(H, 3 * H, scale=H ** -0.5)
    return dict(xs=randn(T, B, 3 * H), mask=mask.contiguous(),
                wg=w0[:, :2 * H], ws=w0[:, 2 * H:],
                bias=randn(3 * H, scale=0.1), h0=randn(B, H, scale=0.5))


def _gru_bound_ms(B, H, T, residuals=False):
    """The recurrence: its two products, 2*B*H*3H per step; xs, mask, W,
    h0 in, ys and hT (or the residuals hs and gates) out."""
    outs = (T * B * H + T * B * 3 * H) if residuals else B * H
    return _bound(2.0 * B * H * 3 * H * T,
                  4 * (T * B * 3 * H + T * B + 3 * H * H + B * H
                       + T * B * H + outs))


def _gru_chain_bound_ms(B, H, T):
    """The backward's reverse chain: its three products, 6*B*H*H per
    step; dys, mask, gates, h0, hs, W, dhT in; dxs, dh0 out."""
    return _bound(6.0 * B * H * H * T,
                  4 * (T * B * H + T * B + 3 * T * B * H + B * H + T * B * H
                       + 3 * H * H + B * H + 3 * T * B * H + B * H))


def _gru_route_check(a, B, H, T, seed, two_launch):
    """One route at one shape: the primal forward in both directions
    through ``gru_sequence`` and the residual forward against the plain
    loops; every gradient through ``GruFunction`` (both directions)
    against autograd of the plain loop; the backward against the plain
    step loop; on the chain, two runs bit-equal. Returns (fwd_err,
    bwd_err, res)."""
    fwd_err, bwd_err = 0.0, 0.0
    names = ("xs", "wg", "ws", "bias", "h0")
    where = f"GRU B={B} H={H} T={T} two_launch={two_launch}"
    for reverse in (False, True):
        with torch.no_grad():
            got = G.gru_sequence(a["xs"], a["mask"], a["wg"], a["ws"],
                                 a["bias"], a["h0"], reverse=reverse,
                                 two_launch=two_launch)
        leaves = {k: a[k].detach().clone().requires_grad_(True)
                  for k in names}
        xs_p, m_p = ((leaves["xs"].flip(0), a["mask"].flip(0)) if reverse
                     else (leaves["xs"], a["mask"]))
        ys_p, hT_p = G.gru_sequence_plain(xs_p + leaves["bias"], m_p,
                                          leaves["wg"], leaves["ws"],
                                          leaves["h0"])
        want = (ys_p.flip(0) if reverse else ys_p, hT_p)
        for name, g, w in zip(("ys", "hT"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{where}: {name} not finite")
            fwd_err = max(fwd_err, (g - w).abs().max().item())
            torch.testing.assert_close(
                g, w.detach(), **TOL, msg=lambda m: f"{where} "
                f"reverse={reverse} {name}: {m}")
        gen = torch.Generator(device="cuda").manual_seed(seed + reverse)
        dys = torch.randn(want[0].shape, generator=gen, device="cuda")
        dhT = torch.randn(want[1].shape, generator=gen, device="cuda")
        want_g = torch.autograd.grad(
            (want[0] * dys).sum() + (want[1] * dhT).sum(),
            [leaves[k] for k in names])
        kl = {k: a[k].detach().clone().requires_grad_(True) for k in names}
        ys, hT = G.gru_sequence(kl["xs"], a["mask"], kl["wg"], kl["ws"],
                                kl["bias"], kl["h0"], reverse=reverse,
                                two_launch=two_launch)
        got_g = torch.autograd.grad((ys * dys).sum() + (hT * dhT).sum(),
                                    [kl[k] for k in names])
        torch.cuda.synchronize()
        bwd_err = max(bwd_err, _check_grads(f"{where} reverse={reverse}",
                                            got_g, want_g, names))
    xs_b = (a["xs"] + a["bias"]).contiguous()
    args = (xs_b, a["mask"], a["wg"], a["ws"], a["h0"])
    res_got = G.gru_seq_train(*args, two_launch=two_launch)
    torch.cuda.synchronize()
    res_want = G.gru_sequence_residual_plain(*args)
    for name, g, w in zip(("ys", "hs", "gates"), res_got, res_want):
        fwd_err = max(fwd_err, (g - w).abs().max().item())
        torch.testing.assert_close(
            g, w, **TOL, msg=lambda m: f"{where} residual {name}: {m}")
    _, hs, gates = res_got
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    dys = torch.randn(T, B, H, generator=gen, device="cuda")
    dhT = torch.randn(B, H, generator=gen, device="cuda")
    res = (a["mask"], a["wg"], a["ws"], a["h0"], hs, gates, dys, dhT)
    got_b = G.gru_backward(*res, two_launch=two_launch)
    torch.cuda.synchronize()
    bwd_err = max(bwd_err, _check_grads(
        f"{where} backward", got_b,
        G.gru_backward(*res, step=G.gru_bwd_step_plain),
        ("xs", "wg", "ws", "h0")))
    if not two_launch:
        again = G.gru_backward(*res)
        for name, g, g2 in zip(("dxs", "dWg", "dWs", "dh0"), got_b, again):
            if not torch.equal(g, g2):
                raise AssertionError(f"{where}: two chain runs differ in "
                                     f"{name}")
    return fwd_err, bwd_err, res


def check_gru_shape(B, H, T, seed):
    """Both routes at one shape (the persistent one where ``gru_route``
    takes it): correctness as ``_gru_route_check``; CUDA-event times of
    the primal and residual forward and of the whole backward, the device
    time (``torch.profiler``) of the residual forward and of the reverse
    chain or per-step kernels; the plain versions' times; the bounds."""
    a = _gru_inputs(B, H, T, seed)
    if a["wg"].is_contiguous() or a["ws"].is_contiguous():
        raise AssertionError("the GRU check must pass strided w0 slices")
    route = G.gru_route(B, H, G.device_sms(a["xs"]))
    routes = (False, True) if route == G.PERSISTENT else (True,)
    row = dict(B=B, H=H, T=T, route=route, fwd_max_abs_err=0.0,
               bwd_max_abs_err=0.0)
    xs_b = (a["xs"] + a["bias"]).contiguous()
    args = (xs_b, a["mask"], a["wg"], a["ws"], a["h0"])
    reps = 5 if T * B * H > 50 * 50 * 512 else 10
    calls = 3 if T > 100 else 10
    for two_launch in routes:
        fwd_err, bwd_err, res = _gru_route_check(a, B, H, T, seed,
                                                 two_launch)
        row["fwd_max_abs_err"] = max(row["fwd_max_abs_err"], fwd_err)
        row["bwd_max_abs_err"] = max(row["bwd_max_abs_err"], bwd_err)
        p = "two_launch_" if two_launch else ""
        kw = dict(two_launch=two_launch)
        row[p + "ms"] = _time_ms(lambda: G.gru_seq(*args, **kw), reps=reps)
        row[p + "train_ms"] = _time_ms(lambda: G.gru_seq_train(*args, **kw),
                                       reps=reps)
        row[p + "bwd_ms"] = _time_ms(lambda: G.gru_backward(*res, **kw),
                                     reps=reps)
        fwd_names, per = ((("gru_gate_kernel", "gru_state_kernel"), T)
                          if two_launch else (("gru_persistent_kernel",), 1))
        row[p + "train_device_ms"] = _device_ms(
            lambda: G.gru_seq_train(*args, **kw), fwd_names, calls, per)[0]
        # every kernel of the backward: the chain or the per-step kernels
        # and their cuBLAS products, and the two dW products
        row[p + "bwd_device_ms"] = _device_ms(
            lambda: G.gru_backward(*res, **kw), None, calls)[0]
    mask, wg, ws, h0, hs, gates, dys, dhT = res
    chain_args = (dys, mask, gates, h0, hs, wg, ws, dhT)
    def step_loop():  # the two-launch route's reverse chain, no dW
        dh, drh = dhT.clone(), torch.empty_like(dhT)
        dxs = torch.empty_like(gates)
        for t in range(T - 1, -1, -1):
            G.gru_bwd_step(dys[t], mask[t], gates[t],
                           hs[t - 1] if t else h0, wg, ws, dh, drh, dxs[t])

    row["step_loop_ms"] = _time_ms(step_loop, reps=reps)
    if route == G.PERSISTENT:
        row["chain_ms"] = _time_ms(lambda: G.gru_bwd_chain(*chain_args),
                                   reps=reps)
        row["chain_device_ms"] = _device_ms(
            lambda: G.gru_bwd_chain(*chain_args), "gru_bwd_chain_kernel",
            calls)[0]
        row["chain_plain_ms"] = _time_ms(
            lambda: G.gru_bwd_chain_plain(*chain_args), reps=reps)
    row["plain_ms"] = _time_ms(lambda: G.gru_sequence_plain(*args),
                               reps=reps)
    row["train_plain_ms"] = _time_ms(
        lambda: G.gru_sequence_residual_plain(*args), reps=reps)
    row["bwd_plain_ms"] = _time_ms(lambda: G.gru_backward(
        *res, step=G.gru_bwd_step_plain), reps=reps)
    # one reverse step (the last) of the two-launch route, on copies of
    # its in-place operands
    h_pv = hs[-2] if T > 1 else h0
    step = lambda fn: fn(dys[-1], mask[-1], gates[-1], h_pv, wg, ws,
                         dhT.clone(), torch.empty_like(dhT),
                         torch.empty_like(gates[-1]))
    row["step_ms"] = _time_ms(lambda: step(G.gru_bwd_step), reps=50)
    row["step_plain_ms"] = _time_ms(lambda: step(G.gru_bwd_step_plain),
                                    reps=50)
    row["bound_ms"], row["bound_by"] = _gru_bound_ms(B, H, T)
    row["train_bound_ms"], row["train_bound_by"] = _gru_bound_ms(B, H, T,
                                                                 True)
    row["chain_bound_ms"], row["chain_bound_by"] = _gru_chain_bound_ms(
        B, H, T)
    # one backward step: dy, mask, gates, h_prev, dh, Wg, Ws in; dh, dxs,
    # drh out; the products 2*B*H*H and 2*B*2H*H plus ~25 operations per
    # element
    row["step_bound_ms"], row["step_bound_by"] = _bound(
        6.0 * B * H * H + 25.0 * B * H,
        4 * (B + 6 * B * H + 3 * H * H + 5 * B * H))
    if route == G.PERSISTENT:
        for key in ("ms", "train_ms", "bwd_ms", "train_device_ms",
                    "bwd_device_ms"):
            row["speedup_" + key] = row["two_launch_" + key] / row[key]
        row["speedup_chain_vs_step_loop"] = row["step_loop_ms"] / \
            row["chain_ms"]
    phase("gru_kernel_check", **row)
    return row


def _host_us(fn, calls=400, sync_every=50):
    """Host time of one call of ``fn``, us: the median of ``calls`` calls,
    each timed alone by ``time.perf_counter_ns``, with the device drained
    (untimed) every ``sync_every`` calls so that a full launch queue never
    holds the host."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
        if i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return 1e-3 * statistics.median(times)


def _split_us(groups, rounds=5, calls=400):
    """{group: {piece: host us}} of named zero-argument callables, each
    group run with autograd on or off ({group: (grad, pieces)}): the
    median over ``rounds`` rounds, each timing every piece of every group
    in turn (``_host_us`` over ``calls`` calls), so that a drift of the
    host's speed during the run reaches every piece alike."""
    got = {g: {name: [] for name in pieces}
           for g, (_, pieces) in groups.items()}
    for _ in range(rounds):
        for g, (grad, pieces) in groups.items():
            with torch.set_grad_enabled(grad):
                for name, fn in pieces.items():
                    got[g][name].append(_host_us(fn, calls))
    return {g: {name: statistics.median(v) for name, v in d.items()}
            for g, d in got.items()}


def _baseline_gru_cell_pieces(x, h, wg, ws):
    """The GRU cell's host path in its baseline spelling (per-tensor
    checks: ``cuda_device``, ``check_tensors`` and two
    ``check_weight``, three ``torch.empty``, a ``torch.cuda.device`` guard
    and ``current_stream()``, seven ``data_ptr()``, the two-launch entry),
    piece by piece and whole: the "before" of the host split."""
    k = "gru_cell_infer"
    B, H = h.shape
    dev = h.device
    fn = build.bind("gru_seq", "gru_cell_forward", 7, 4)
    bufs = [torch.empty((B, 3 * H), device=dev),
            torch.empty((B, H), device=dev), torch.empty((B, H), device=dev)]
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), h.data_ptr(), wg.data_ptr(), ws.data_ptr(),
            *(b.data_ptr() for b in bufs), wg.stride(0), ws.stride(0), B, H,
            stream)

    def checks():
        d = build.cuda_device(k, x)
        build.check_tensors(k, d, x=(x, (B, 3 * H)), h=(h, (B, H)))
        build.check_weight(k, d, "w_gate", wg, (H, 2 * H))
        build.check_weight(k, d, "w_state", ws, (H, H))

    def alloc():
        for shape in ((B, 3 * H), (B, H), (B, H)):
            torch.empty(shape, dtype=torch.float32, device=dev)

    def guard_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    def whole():
        checks()
        alloc()
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream().cuda_stream
            build.raise_on(fn(*args[:-1], st), k)

    return dict(checks=checks, alloc=alloc, guard_stream=guard_stream,
                data_ptr=lambda: [t.data_ptr() for t in (x, h, wg, ws,
                                                         *bufs)],
                ctypes_call=lambda: fn(*args), whole=whole)


def _gru_cell_pieces(x, h, wg, ws):
    """The same pieces of the cluster route's path (``_gru_launch``)."""
    k = "gru_cell_infer"
    B, H = h.shape
    idx = h.get_device()
    plan = C._card_plan(B, H, idx)
    out = torch.empty_like(h)
    fn = build.bind("gru_cell", "gru_cell_cluster_forward", 5, 6)
    args = (x.data_ptr(), h.data_ptr(), wg.data_ptr(), ws.data_ptr(),
            out.data_ptr(), wg.stride(0), ws.stride(0), B, H,
            plan["cluster"], plan["rows"],
            torch.cuda.current_stream().cuda_stream)
    return dict(
        checks=lambda: build.check_cell(
            k, (("x", x, (B, 3 * H)), ("h", h, (B, H))),
            (("w_gate", wg, (H, 2 * H)), ("w_state", ws, (H, H)))),
        alloc=lambda: torch.empty_like(h),
        guard_stream=lambda: (torch.cuda.current_device() == idx,
                              torch._C._cuda_getCurrentRawStream(idx)),
        plan=lambda: C._card_plan(B, H, idx),
        data_ptr=lambda: [t.data_ptr() for t in (x, h, wg, ws, out)],
        ctypes_call=lambda: fn(*args),
        whole=lambda: C._gru_launch(k, x, h, wg, ws))


def _entry_pieces(infer, train, ins):
    """The whole no-grad entry and the training entry on leaves that want
    a gradient (its autograd.Function, save_for_backward and the graph's
    node): (infer group, train group) for ``_split_us``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    return ((False, dict(infer_entry=lambda: infer(*ins))),
            (True, dict(train_entry=lambda: train(*leaves))))


def _host_split(baseline, now, infer, train, ins, **more):
    """The host split of a cell's launch path, the baseline spelling and
    today's, and of its entries (``autograd``: train minus infer entry),
    all interleaved in one ``_split_us``; ``more``: other entries'
    (infer, train) pairs, named."""
    groups = dict(baseline=(False, baseline), now=(False, now))
    pairs = dict(entry=(infer, train), **more)
    for name, (inf, tr) in pairs.items():
        groups[name + "_infer"], groups[name + "_train"] = _entry_pieces(
            inf, tr, ins)
    got = _split_us(groups)
    out = dict(host_us_baseline=got["baseline"], host_us=got["now"])
    for name in pairs:
        t_inf = got[name + "_infer"]["infer_entry"]
        t_tr = got[name + "_train"]["train_entry"]
        d = dict(infer_entry=t_inf, train_entry=t_tr, autograd=t_tr - t_inf)
        if name == "entry":
            out["host_us"].update(d)
        else:
            out["host_us_" + name] = d
    return out


def _cluster_sizes(B, H, seed):
    """The cluster kernel at cluster sizes 16 and 8 where both plans fit,
    launched directly with each plan: device ms and the clusters the card
    places at once."""
    a = _gru_inputs(B, H, 1, seed)
    x, h, wg, ws = a["xs"][0].contiguous(), a["h0"], a["wg"], a["ws"]
    fn = build.bind("gru_cell", "gru_cell_cluster_forward", 5, 6)
    out = {}
    for size in (16, 8):
        plan = C.gru_cell_plan(B, H, build.device_sms(h), cluster=size)
        if plan["route"] != C.CLUSTER:
            out[size] = dict(plan=plan)
            continue
        slots = C.gru_cell_max_clusters(H, plan["cluster"], 1)
        plan = C.gru_cell_plan(B, H, build.device_sms(h), slots,
                               cluster=size)
        y = torch.empty_like(h)

        def launch():
            C._raise_cluster(fn(
                x.data_ptr(), h.data_ptr(), wg.data_ptr(), ws.data_ptr(),
                y.data_ptr(), wg.stride(0), ws.stride(0), B, H,
                plan["cluster"], plan["rows"],
                torch.cuda.current_stream().cuda_stream), "gru_cell", plan)

        launch()
        torch.cuda.synchronize()
        torch.testing.assert_close(y, C.gru_cell_plain(x, h, wg, ws), **TOL)
        ms, trace = _device_ms(launch, "gru_cell_cluster_kernel")
        out[size] = dict(plan=plan, device_ms=ms, device_trace=trace)
    return dict(B=B, H=H, sizes=out)


def check_gru_cell(B, H, seed, split=False):
    """The cell's kernel on both routes (the cluster route, one launch a
    call, and the two-launch route, forced with ``two_launch=True``):
    both entries' forward against the plain math on strided w0 slices,
    two cluster runs bit-equal, the recompute backward against autograd
    of the plain math, the launch counts; CUDA-event and profiler device
    times of both routes, ``speedup_*``; with ``split``, the host split of
    the cluster route's path beside the baseline spelling's."""
    a = _gru_inputs(B, H, 1, seed)
    x = a["xs"][0].contiguous()
    names = ("x", "h", "wg", "ws")
    base = dict(x=x, h=a["h0"], wg=a["wg"], ws=a["ws"])
    args = (x, a["h0"], a["wg"], a["ws"])
    plan = C._card_plan(B, H, x.get_device())
    if plan["route"] != C.CLUSTER:
        raise AssertionError(f"gru_cell B={B} H={H} is off the cluster "
                             f"route: {plan}")
    want = C.gru_cell_plain(*args)
    row = dict(B=B, H=H, plan=plan)
    err = bwd_err = 0.0
    for two_launch in (False, True):
        key = "two_launch_" if two_launch else ""
        plain = {k: v.detach().clone().requires_grad_(True)
                 for k, v in base.items()}
        kern = {k: v.detach().clone().requires_grad_(True)
                for k, v in base.items()}
        want_g = C.gru_cell_plain(*(plain[k] for k in names))
        before = {n: (getattr(C, n).launches, getattr(C, n).step_launches)
                  for n in ("gru_cell", "gru_cell_infer")}
        got = C.gru_cell(*(kern[k] for k in names), two_launch=two_launch)
        with torch.no_grad():
            got_i = C.gru_cell_infer(*args, two_launch=two_launch)
            got_i2 = C.gru_cell_infer(*args, two_launch=two_launch)
        torch.cuda.synchronize()
        steps = 2 if two_launch else 1
        for n, calls in (("gru_cell", 1), ("gru_cell_infer", 2)):
            fn = getattr(C, n)
            if (fn.launches - before[n][0], fn.step_launches
                    - before[n][1]) != (calls, steps * calls):
                raise AssertionError(f"{n} B={B} H={H} two_launch="
                                     f"{two_launch}: counts {before[n]} -> "
                                     f"{(fn.launches, fn.step_launches)}")
        if not torch.equal(got_i, got_i2):
            raise AssertionError(f"gru_cell_infer B={B} H={H}: two runs "
                                 "differ")
        for name, g in (("gru_cell", got), ("gru_cell_infer", got_i)):
            err = max(err, (g - want).abs().max().item())
            torch.testing.assert_close(
                g.detach(), want, **TOL,
                msg=lambda m: f"{name} B={B} H={H} {key}: {m}")
        dout = torch.randn_like(want)
        bwd_err = max(bwd_err, _check_grads(
            f"gru_cell B={B} H={H} {key}",
            torch.autograd.grad(got, [kern[k] for k in names], dout),
            torch.autograd.grad(want_g, [plain[k] for k in names], dout),
            names))
        kernels = (("gru_gate_kernel", "gru_state_kernel") if two_launch
                   else "gru_cell_cluster_kernel")
        with torch.no_grad():
            call = lambda: C.gru_cell_infer(*args, two_launch=two_launch)
            row[key + "ms"] = _time_ms(call, reps=50)
            row[key + "device_ms"], row[key + "device_trace"] = \
                _device_ms(call, kernels)
    row["speedup_ms"] = row["two_launch_ms"] / row["ms"]
    row["speedup_device_ms"] = row["two_launch_device_ms"] / \
        row["device_ms"]
    row.update(max_abs_err=err, bwd_max_abs_err=bwd_err)
    with torch.no_grad():
        row["plain_ms"] = _time_ms(lambda: C.gru_cell_plain(*args))
    # x, h, W in; h_new out; the two products 2*B*H*3H
    row["bound_ms"], row["bound_by"] = _bound(
        2.0 * B * H * 3 * H, 4 * (B * 3 * H + 2 * B * H + 3 * H * H))
    if split:
        row.update(_host_split(
            _baseline_gru_cell_pieces(*args), _gru_cell_pieces(*args),
            C.gru_cell_infer, C.gru_cell, args,
            two_launch=(lambda *t: C.gru_cell_infer(*t, two_launch=True),
                        lambda *t: C.gru_cell(*t, two_launch=True))))
    phase("gru_cell_check", **row)
    return row


def check_gru_kernels():
    rows = [check_gru_shape(B, H, T, seed=3 * B + H + T)
            for B, H, T in GRU_SHAPES + [GRU_ABOVE_LINE]]
    return rows, check_gru_cells()


def check_gru_cells():
    """The GRU cell at every GRU_CELL_SHAPES (the host split at the first)
    and the cluster sizes side by side."""
    cells = [check_gru_cell(B, H, seed=B + 11 * H, split=i == 0)
             for i, (B, H) in enumerate(GRU_CELL_SHAPES)]
    sizes = [_cluster_sizes(B, H, seed=B + H) for B, H in CLUSTER_SHAPES]
    phase("gru_cell_cluster_sizes", rows=sizes)
    cells[0]["cluster_sizes"] = sizes
    return cells


# --------------------------------------------- 5b. LSTM cell kernel check
def _lstm_cell_pieces(ins, baseline):
    """The LSTM cell's host path, piece by piece and whole: ``baseline``,
    in its baseline spelling (``cuda_device`` and
    ``check_tensors`` over 5 tensors, two ``torch.empty``, a
    ``torch.cuda.device`` guard and ``current_stream()``), else as the
    wrapper spells it now (``check_cell``, two ``empty_like``,
    ``build.call``)."""
    k = "lstm_cell_infer"
    gates, c_prev, ci, cf, co = ins
    B, H = c_prev.shape
    dev, idx = c_prev.device, c_prev.get_device()
    fn = build.bind("lstm_cell", "lstm_cell_forward", 7, 2)
    h, c = torch.empty_like(c_prev), torch.empty_like(c_prev)
    args = (*(t.data_ptr() for t in (*ins, h, c)), B, H,
            torch.cuda.current_stream().cuda_stream)
    pieces = dict(data_ptr=lambda: [t.data_ptr() for t in (*ins, h, c)],
                  ctypes_call=lambda: fn(*args))
    if not baseline:
        pieces.update(
            checks=lambda: build.check_cell(k, (
                ("gates", gates, (B, 4 * H)), ("c_prev", c_prev, (B, H)),
                ("check_i", ci, (H,)), ("check_f", cf, (H,)),
                ("check_o", co, (H,)))),
            alloc=lambda: (torch.empty_like(c_prev),
                           torch.empty_like(c_prev)),
            guard_stream=lambda: (torch.cuda.current_device() == idx,
                                  torch._C._cuda_getCurrentRawStream(idx)),
            whole=lambda: C._lstm_launch(k, *ins))
        return pieces

    def checks():
        d = build.cuda_device(k, gates)
        build.check_tensors(k, d, gates=(gates, (B, 4 * H)),
                            c_prev=(c_prev, (B, H)), check_i=(ci, (H,)),
                            check_f=(cf, (H,)), check_o=(co, (H,)))

    def alloc():
        return (torch.empty((B, H), dtype=torch.float32, device=dev),
                torch.empty((B, H), dtype=torch.float32, device=dev))

    def guard_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    def whole():
        checks()
        alloc()
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream().cuda_stream
            build.raise_on(fn(*args[:-1], st), k)

    pieces.update(checks=checks, alloc=alloc, guard_stream=guard_stream,
                  whole=whole)
    return pieces


def check_lstm_cell(B, H, seed, split=False):
    """The LSTM cell kernel (training and inference entries) against
    ``lstm_cell_plain`` with nonzero peepholes, h and c within rtol 1e-4 /
    atol 1e-5; the gradient through ``LstmCellFunction`` against autograd
    of the plain version (per tensor within 1e-4 of the largest entry +
    1e-5). Times of one step: CUDA events around the wrapper (median of
    10), the kernel's device time (``torch.profiler``), the plain
    version, beside the bound."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ins = [torch.randn(B, 4 * H, generator=g, device="cuda"),
           torch.randn(B, H, generator=g, device="cuda"),
           *(0.5 * torch.randn(H, generator=g, device="cuda")
             for _ in range(3))]
    names = ("gates", "c_prev", "check_i", "check_f", "check_o")
    plain = [t.detach().clone().requires_grad_(True) for t in ins]
    kern = [t.detach().clone().requires_grad_(True) for t in ins]
    want = C.lstm_cell_plain(*plain)
    got = C.lstm_cell(*kern)
    with torch.no_grad():
        got_i = C.lstm_cell_infer(*ins)
    torch.cuda.synchronize()
    err = 0.0
    for entry, out in (("lstm_cell", got), ("lstm_cell_infer", got_i)):
        for part, g_t, w_t in zip(("h", "c"), out, want):
            err = max(err, (g_t - w_t).abs().max().item())
            torch.testing.assert_close(
                g_t.detach(), w_t.detach(), **TOL,
                msg=lambda m: f"{entry} {part} B={B} H={H}: {m}")
    cot = [torch.randn_like(want[0]), torch.randn_like(want[1])]
    bwd_err = _check_grads(f"lstm_cell B={B} H={H}",
                           torch.autograd.grad(got, kern, cot),
                           torch.autograd.grad(want, plain, cot), names)
    with torch.no_grad():
        dev_ms, dev_trace = _device_ms(lambda: C.lstm_cell_infer(*ins),
                                       "lstm_cell_kernel")
        row = dict(B=B, H=H, max_abs_err=err, bwd_max_abs_err=bwd_err,
                   ms=_time_ms(lambda: C.lstm_cell_infer(*ins), reps=50),
                   device_ms=dev_ms, device_trace=dev_trace,
                   plain_ms=_time_ms(lambda: C.lstm_cell_plain(*ins)))
    # gates, c_prev, the peepholes in; h, c out; ~30 operations an element
    row["bound_ms"], row["bound_by"] = _bound(
        30.0 * B * H, 4 * (4 * B * H + B * H + 3 * H + 2 * B * H))
    if split:
        row.update(_host_split(
            _lstm_cell_pieces(ins, True), _lstm_cell_pieces(ins, False),
            C.lstm_cell_infer, C.lstm_cell, ins))
    phase("lstm_cell_check", **row)
    return row


def check_lstm_cells():
    """The LSTM cell at every LSTM_CELL_SHAPES, the host split at the
    first (the decode's 32 rows)."""
    return [check_lstm_cell(B, H, seed=B + 7 * H, split=i == 0)
            for i, (B, H) in enumerate(LSTM_CELL_SHAPES)]


def cell_kernels():
    """``--cell-kernels``: phases 5 and 5b for the two recurrent-step
    cells alone (both GRU-cell routes at GRU_CELL_SHAPES, the cluster
    sizes, the LSTM cell at LSTM_CELL_SHAPES, the host splits); rows in
    ``cell_kernels.json`` in ``OUT_DIR``."""
    build.build_all(["gru_seq", "gru_cell", "lstm_cell"])
    out = dict(gru_cell=check_gru_cells(), lstm_cell=check_lstm_cells())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "cell_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)


# --------------------------------------------------- 6. CRF kernel check
def _crf_inputs(B, T, C, seed):
    """x [B,T,C], ragged lengths 1..T (row 0 full; with more than one row,
    the last all padding, as a batch bucket pads it), trans with two
    forbidden transitions (-1e4), a, b, and the cotangent g [B]."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None]).float()
    trans = randn(C, C)
    trans[0, 1] = trans[2, 3] = -1e4
    return randn(B, T, C), mask.contiguous(), trans, randn(C), randn(C), \
        randn(B)


def _crf_bounds(B, T, C, mask):
    """Least times of the three kernels for these inputs, by the work this
    mask needs: live steps (t >= 1 with mask 1) and live pairs (steps t
    and t-1 both real). Forward: 2C^2 + 6C operations per live step
    (product, max, exp, log, adds) and 5C per sequence; x, mask, trans, a,
    b in, alphas and log Z out. Backward: per step 6C for the unary
    marginal, per live pair 7C^2 (the pairwise marginal's three adds, min,
    exp, product and sum), per live step 2C^2 + 7C (the beta step); x,
    mask, trans, b, alphas, log Z, g in, dx, dtrans, da, db out. Viterbi:
    2C^2 + C per live step (adds and compares); x, mask, trans, a, b in,
    the path and the score out."""
    live = float(mask[:, 1:].sum())
    pairs = float((mask[:, 1:] * mask[:, :-1]).sum())
    steps = float(B * T)
    ins = 4 * (B * T * C + B * T + C * C + 2 * C)
    return {
        "fwd": _bound(live * (2 * C * C + 6 * C) + 5.0 * B * C,
                      ins + 4 * (B * T * C + B)),
        "bwd": _bound(steps * 6 * C + pairs * 7 * C * C
                      + live * (2 * C * C + 7 * C),
                      ins + 4 * (B * T * C + 2 * B)
                      + 4 * (B * T * C + C * C + 2 * C)),
        "viterbi": _bound(live * (2 * C * C + C) + 3.0 * B * C,
                          ins + 4 * (B * T + B)),
    }


def _crf_floor_us(C, variant):
    """A chain step's least time at C classes, us: CUDA events around one
    launch of ``crf_chain_floor`` (the chain's own step function, the
    beta, Viterbi or alpha ``variant``, one block, CRF_FLOOR_STEPS steps,
    no global memory), median of 5, over the steps."""
    return 1e3 * _time_ms(lambda: CRF.crf_chain_floor(
        CRF_FLOOR_STEPS, C, variant), reps=5, warmup=1) / CRF_FLOOR_STEPS


def _crf_alpha_fwd_lanes(x, mask, trans, a, b):
    """The forward's earlier spelling, replayed for the comparison: the
    wrapper's checks, the outputs and the scratch of the global-memory
    path, the earlier kernel (``crf_alpha_fwd_lanes``: a warp a sequence,
    8 classes a lane, C <= 256; above C = 239 ``crf_prep_kernel`` first).
    Uncounted."""
    vec = CRF._VEC
    idx, B, T, C, _ = CRF._check("crf_alpha_fwd", x, mask, trans,
                              (("a", a, vec), ("b", b, vec)))
    alphas = torch.empty((B, T, C), dtype=torch.float32, device=x.device)
    log_z = torch.empty((B,), dtype=torch.float32, device=x.device)
    n = CRF._work_floats(0, C)
    work = torch.empty((n,), dtype=torch.float32, device=x.device) \
        if n else None
    err = build.call(build.bind("crf", "crf_alpha_fwd_lanes", 8, 3), idx,
                     x.data_ptr(), mask.data_ptr(), trans.data_ptr(),
                     a.data_ptr(), b.data_ptr(), CRF._ptr(work),
                     alphas.data_ptr(), log_z.data_ptr(), B, T, C)
    build.raise_on(err, "crf_alpha_fwd_lanes")
    return alphas, log_z


def _crf_bwd_inline(x, mask, trans, b, alphas, log_z, g):
    """The backward's earlier spelling, replayed for the comparison: the
    per-tensor checks, per-sequence partials [B,C,C] and [B,C], the
    scratch of the global-memory path, a device guard and
    ``current_stream()``, the inline kernel (``crf_bwd_inline``: the
    pairwise marginals inside the chain), then three torch sums over the
    batch. Uncounted."""
    dev = build.cuda_device("crf_bwd", x)
    B, T, C = x.shape
    build.check_tensors("crf_bwd", dev, x=(x, (B, T, C)), mask=(mask, (B, T)),
                        trans=(trans, (C, C)), b=(b, (C,)),
                        alphas=(alphas, (B, T, C)), log_z=(log_z, (B,)),
                        g=(g, (B,)))
    dx = torch.empty((B, T, C), device=dev)
    dtrans = torch.empty((B, C, C), device=dev)
    da, db = (torch.empty((B, C), device=dev) for _ in range(2))
    n = CRF._work_floats(1, C)
    work = torch.empty((n,), device=dev) if n else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("crf", "crf_bwd_inline", 12, 3)(
            x.data_ptr(), mask.data_ptr(), trans.data_ptr(), b.data_ptr(),
            alphas.data_ptr(), log_z.data_ptr(), g.data_ptr(),
            CRF._ptr(work), dx.data_ptr(), dtrans.data_ptr(), da.data_ptr(),
            db.data_ptr(), B, T, C, stream)
    build.raise_on(err, "crf_bwd_inline")
    return dx, dtrans.sum(dim=0), da.sum(dim=0), db.sum(dim=0)


def _crf_viterbi_scratch(x, mask, trans, a, b):
    """The Viterbi's earlier spelling: per-tensor checks, an int32
    back-pointer scratch [B,T,C] a call, a device guard and
    ``current_stream()``, ``crf_viterbi_scratch``. Uncounted."""
    dev = build.cuda_device("crf_viterbi", x)
    B, T, C = x.shape
    build.check_tensors("crf_viterbi", dev, x=(x, (B, T, C)),
                        mask=(mask, (B, T)), trans=(trans, (C, C)),
                        a=(a, (C,)), b=(b, (C,)))
    ptr = torch.empty((B, T, C), dtype=torch.int32, device=dev)
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("crf", "crf_viterbi_scratch", 8, 3)(
            x.data_ptr(), mask.data_ptr(), trans.data_ptr(), a.data_ptr(),
            b.data_ptr(), ptr.data_ptr(), path.data_ptr(), score.data_ptr(),
            B, T, C, stream)
    build.raise_on(err, "crf_viterbi_scratch")
    return path, score


_CRF_KERNELS = dict(bwd=("crf_bwd_fused_kernel", "crf_sum_kernel",
                         "crf_beta_block_kernel", "crf_marginal_kernel"),
                    viterbi=("crf_decode_",),
                    fwd=("crf_alpha_warp_kernel", "crf_alpha_block_kernel"),
                    fwd_before=("crf_alpha_fwd_kernel", "crf_prep_kernel"),
                    bwd_before=("crf_bwd_kernel", "crf_prep_kernel"),
                    viterbi_before=("crf_viterbi_kernel",))


def _crf_launches(kind, fn, calls=20):
    """The CUDA kernels of ``calls`` calls of a wrapper (union of the
    profiler's traces): every one must be the wrapper's own, at most one a
    call each, two kernels for the backward (C <= 32 the one-launch
    backward and the sum over the batch, above the beta chain and the
    marginal pass), one for the forward and for the Viterbi. Returns
    {kernel: launches}."""
    _, record = _device_ms(fn, None, calls)
    seen = {}
    for tr in record["traces"]:
        for k, (n, _) in tr.items():
            seen[k] = max(seen.get(k, 0), n)
    names = _CRF_KERNELS[kind]
    if not seen or any(not any(n in k for n in names) or v > calls
                       for k, v in seen.items()):
        raise AssertionError(f"crf {kind}: {calls} calls ran {seen}")
    if len(seen) != (2 if kind == "bwd" else 1):
        raise AssertionError(f"crf {kind}: {calls} calls ran {seen}")
    return seen


def _crf_fwd_err(where, got, want):
    """alphas and log Z within rtol 1e-4 / atol 1e-5 of the plain
    forward's, finite; returns the largest error."""
    err = 0.0
    for name, g, w in zip(("alphas", "log_z"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{where}: {name} is not finite")
        err = max(err, (g - w).abs().max().item())
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: (
            f"{where} {name}: {m}"))
    return err


def check_crf_shape(B, T, C, seed, floors):
    """The CRF kernels against their plain versions on the same card
    tensors: alphas and log Z within rtol 1e-4 / atol 1e-5, every gradient
    per tensor within 1e-4 of its largest entry + 1e-5, the forbidden
    transitions' gradients finite and near 0, the Viterbi paths identical
    (scores within 1e-5); two backward runs bit-equal; where the forward
    keeps E in shared memory, its global-memory path bit-equal to it; the
    CUDA kernels each wrapper runs; at C <= 256 the earlier forward,
    backward and Viterbi held to the same checks; times, the bounds and
    the chain bounds (``floors``: us a step by (C, variant))."""
    where = f"CRF B={B} T={T} C={C}"
    x, mask, trans, a, b, g = _crf_inputs(B, T, C, seed)
    w_alphas, w_log_z = CRF.crf_forward_plain(x, mask, trans, a, b)
    earlier = C <= CRF_EARLIER_MAX_C
    row = dict(B=B, T=T, C=C, live_steps=float(mask[:, 1:].sum()),
               plan=CRF.crf_plan(T, C),
               marginal_plan=CRF.crf_marginal_plan(B, T, C))
    alphas, log_z = CRF.crf_alpha_fwd(x, mask, trans, a, b)
    torch.cuda.synchronize()
    row["fwd_max_abs_err"] = _crf_fwd_err(where, (alphas, log_z),
                                          (w_alphas, w_log_z))
    w_grads = CRF.crf_bwd_plain(x, mask, trans, b, w_alphas, w_log_z, g)
    w_path, w_score = CRF.crf_viterbi_plain(x, mask, trans, a, b)
    bwd_args = (x, mask, trans, b, alphas, log_z, g)
    vit_args = (x, mask, trans, a, b)
    kinds = [("bwd", CRF.crf_bwd, CRF.crf_bwd_plain, bwd_args),
             ("viterbi", CRF.crf_viterbi, CRF.crf_viterbi_plain, vit_args)]
    if earlier:
        kinds += [("bwd_before", _crf_bwd_inline, None, bwd_args),
                  ("viterbi_before", _crf_viterbi_scratch, None, vit_args)]
        row["fwd_before_max_abs_err"] = _crf_fwd_err(
            f"{where} fwd_before", _crf_alpha_fwd_lanes(*vit_args),
            (w_alphas, w_log_z))
    for kind, fn, _, args in kinds:
        got = fn(*args)
        torch.cuda.synchronize()
        if kind.startswith("bwd"):
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"{where}: a {kind} gradient is not "
                                     "finite")
            row[f"{kind}_max_abs_err"] = _check_grads(
                f"{where} {kind}", got, w_grads, ("x", "trans", "a", "b"))
            forbidden = max(abs(got[1][0, 1].item()),
                            abs(got[1][2, 3].item()))
            if forbidden > 1e-6:
                raise AssertionError(f"{where} {kind}: forbidden "
                                     f"transitions' gradient {forbidden}")
            row[f"{kind}_forbidden_grad"] = forbidden
            if not all(torch.equal(u, v) for u, v in zip(got, fn(*args))):
                raise AssertionError(f"{where}: two {kind} runs differ")
        else:
            path, score = got
            if not torch.equal(path, w_path):
                raise AssertionError(
                    f"{where} {kind}: paths differ at "
                    f"{int((path != w_path).sum())} steps")
            torch.testing.assert_close(score, w_score, rtol=0, atol=1e-5)
            row[f"{kind}_score_err"] = (score - w_score).abs().max().item()
    kinds.insert(0, ("fwd", CRF.crf_alpha_fwd, CRF.crf_forward_plain,
                     vit_args))
    row["launches_of_20_calls"] = {
        kind: _crf_launches(kind, lambda: fn(*args))
        for kind, fn, _, args in kinds[:3]}
    # ms: the kernels' device time (torch.profiler; each kernel's mean a
    # launch, summed: the backward's chain and marginal pass, the earlier
    # kernels' prep where they launch it); call_ms: CUDA events around one
    # wrapper call, median of 50 (the host work inside counts: checks,
    # allocations, the ctypes call; the earlier backward's three sums);
    # plain_ms: the plain version, median of 10. The forward's
    # global-memory path (the same bits) is timed beside it where E fits
    # shared memory: global_ms, global_call_ms
    if earlier:
        kinds.append(("fwd_before", _crf_alpha_fwd_lanes, None, vit_args))
    for kind, fn, plain, args in kinds:
        row[f"{kind}_ms"], row[f"{kind}_trace"] = _device_ms(
            lambda: fn(*args), _CRF_KERNELS[kind])
        row[f"{kind}_call_ms"] = _time_ms(lambda: fn(*args), reps=50)
        if plain is not None:
            row[f"{kind}_plain_ms"] = _time_ms(lambda: plain(*args))
    if row["plan"]["fwd"]["matrix_in_smem"]:
        via_global = CRF.crf_alpha_fwd(*vit_args, in_global=True)
        if not all(torch.equal(u, v) for u, v in zip(via_global,
                                                      (alphas, log_z))):
            raise AssertionError(f"{where}: the forward kernel's "
                                 "global-memory path differs")
        row["fwd_global_ms"], row["fwd_global_trace"] = _device_ms(
            lambda: CRF.crf_alpha_fwd(*vit_args, in_global=True),
            _CRF_KERNELS["fwd"])
        row["fwd_global_call_ms"] = _time_ms(
            lambda: CRF.crf_alpha_fwd(*vit_args, in_global=True), reps=50)
    for kind, (bound_ms, bound_by) in _crf_bounds(B, T, C, mask).items():
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms, bound_by
    # the chain bound: the most live steps of any row (each chain's steps
    # t >= 1 with mask 1) times a step's floor at this C
    steps = int(mask[:, 1:].sum(dim=1).max().item()) if B else 0
    row["chain_live_steps"] = steps
    for kind, variant in (("fwd", "alpha"), ("bwd", "beta"),
                          ("viterbi", "viterbi")):
        row[f"{kind}_floor_us"] = floors[C, variant]
        row[f"{kind}_chain_bound_ms"] = 1e-3 * steps * floors[C, variant]
        row[f"{kind}_over_chain_bound"] = (row[f"{kind}_ms"]
                                           / row[f"{kind}_chain_bound_ms"])
        if earlier:
            row[f"{kind}_before_over_now"] = (row[f"{kind}_before_ms"]
                                              / row[f"{kind}_ms"])
    phase("crf_kernel_check", **{k: v for k, v in row.items()
                                 if not k.endswith("_trace")})
    return row


def _crf_fwd_pieces(x, mask, trans, a, b):
    """The host split of the forward wrapper's launch path, piece by piece
    and whole, the earlier spelling's (``_crf_alpha_fwd_lanes``: the
    scratch size asked of the library, the earlier kernel) and today's:
    (baseline, now) groups for ``_split_us``."""
    B, T, C = x.shape
    dev = x.device
    idx = x.get_device()
    vec = CRF._VEC
    alphas = torch.empty((B, T, C), device=dev)
    log_z = torch.empty((B,), device=dev)
    n_old, n_now = CRF._work_floats(0, C), CRF.fwd_work_floats(B, C)
    work_old = torch.empty((n_old,), device=dev) if n_old else None
    work = torch.empty((n_now,), device=dev) if n_now else None
    stream = torch.cuda.current_stream().cuda_stream
    f_old = build.bind("crf", "crf_alpha_fwd_lanes", 8, 3)
    f_now = build.bind("crf", "crf_alpha_fwd", 8, 5)
    ins = (x.data_ptr(), mask.data_ptr(), trans.data_ptr(), a.data_ptr(),
           b.data_ptr())
    outs = (alphas.data_ptr(), log_z.data_ptr(), B, T, C)
    now_stream = lambda: (torch.cuda.current_device() == idx,  # noqa: E731
                          torch._C._cuda_getCurrentRawStream(idx))

    def checks():
        return CRF._check("crf_alpha_fwd", x, mask, trans,
                          (("a", a, vec), ("b", b, vec)))

    def alloc(n):
        return (torch.empty((B, T, C), dtype=torch.float32, device=dev),
                torch.empty((B,), dtype=torch.float32, device=dev),
                torch.empty((n,), dtype=torch.float32, device=dev)
                if n else None)

    return (
        dict(checks=checks,
             alloc=lambda: alloc(CRF._work_floats(0, C)),
             guard_stream=now_stream,
             ctypes_call=lambda keep=(alphas, log_z, work_old): f_old(
                 *ins, CRF._ptr(work_old), *outs, stream),
             whole=lambda: _crf_alpha_fwd_lanes(x, mask, trans, a, b)),
        dict(checks=checks,
             alloc=lambda: alloc(CRF.fwd_work_floats(B, C)),
             guard_stream=now_stream,
             ctypes_call=lambda keep=(alphas, log_z, work): f_now(
                 *ins, CRF._ptr(work), *outs, 0, 0, stream),
             whole=lambda: CRF.crf_alpha_fwd(x, mask, trans, a, b)))


def _crf_pieces(x, mask, trans, a, b, alphas, log_z, g):
    """The host split of both wrappers' launch paths, piece by piece and
    whole, today's and the earlier spelling's (per-tensor checks, a device
    guard and ``current_stream()``, the backward's per-sequence partials
    and sums, the Viterbi's back-pointer scratch): (bwd baseline, bwd now,
    viterbi baseline, viterbi now) groups for ``_split_us``."""
    B, T, C = x.shape
    dev = x.device
    idx = x.get_device()
    vec = lambda B, T, C: (C,)  # noqa: E731
    bwd_more = (("b", b, vec), ("alphas", alphas, lambda B, T, C: (B, T, C)),
                ("log_z", log_z, lambda B, T, C: (B,)),
                ("g", g, lambda B, T, C: (B,)))
    outs = [torch.empty((B, T, C), device=dev), torch.empty((C, C), device=dev),
            torch.empty((C,), device=dev), torch.empty((C,), device=dev)]
    work = torch.empty((CRF.bwd_work_floats(B, T, C),), device=dev)
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    f_bwd = build.bind("crf", "crf_bwd", 12, 4)
    f_vit = build.bind("crf", "crf_viterbi", 8, 4)
    bwd_args = (x.data_ptr(), mask.data_ptr(), trans.data_ptr(), b.data_ptr(),
                alphas.data_ptr(), log_z.data_ptr(), g.data_ptr(),
                work.data_ptr(), *(t.data_ptr() for t in outs), B, T, C, 0,
                stream)
    vit_args = (x.data_ptr(), mask.data_ptr(), trans.data_ptr(), a.data_ptr(),
                b.data_ptr(), None, path.data_ptr(), score.data_ptr(), B, T,
                C, 0, stream)
    o_bwd = build.bind("crf", "crf_bwd_inline", 12, 3)
    o_vit = build.bind("crf", "crf_viterbi_scratch", 8, 3)
    parts = [torch.empty((B, T, C), device=dev),
             torch.empty((B, C, C), device=dev),
             torch.empty((B, C), device=dev), torch.empty((B, C), device=dev)]
    ptr = torch.empty((B, T, C), dtype=torch.int32, device=dev)
    ob_args = bwd_args[:7] + (None, *(t.data_ptr() for t in parts), B, T, C,
                              stream)
    ov_args = vit_args[:5] + (ptr.data_ptr(), path.data_ptr(),
                              score.data_ptr(), B, T, C, stream)

    def base_checks(kernel, **more):
        d = build.cuda_device(kernel, x)
        build.check_tensors(kernel, d, x=(x, (B, T, C)), mask=(mask, (B, T)),
                            trans=(trans, (C, C)), **more)

    def guard_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    now_stream = lambda: (torch.cuda.current_device() == idx,  # noqa: E731
                          torch._C._cuda_getCurrentRawStream(idx))
    return (
        dict(checks=lambda: base_checks(
                 "crf_bwd", b=(b, (C,)), alphas=(alphas, (B, T, C)),
                 log_z=(log_z, (B,)), g=(g, (B,))),
             alloc=lambda: (torch.empty((B, T, C), device=dev),
                            torch.empty((B, C, C), device=dev),
                            torch.empty((B, C), device=dev),
                            torch.empty((B, C), device=dev)),
             guard_stream=guard_stream,
             # the defaults keep alive the tensors whose pointers the
             # bound arguments hold
             ctypes_call=lambda keep=parts: o_bwd(*ob_args),
             sums=lambda: (parts[1].sum(dim=0), parts[2].sum(dim=0),
                           parts[3].sum(dim=0)),
             whole=lambda: _crf_bwd_inline(x, mask, trans, b, alphas, log_z,
                                           g)),
        dict(checks=lambda: CRF._check("crf_bwd", x, mask, trans, bwd_more),
             alloc=lambda: (torch.empty((B, T, C), device=dev),
                            torch.empty((C, C), device=dev),
                            torch.empty((C,), device=dev),
                            torch.empty((C,), device=dev),
                            torch.empty((CRF.bwd_work_floats(B, T, C),),
                                        device=dev)),
             guard_stream=now_stream,
             ctypes_call=lambda keep=(work, *outs): f_bwd(*bwd_args),
             whole=lambda: CRF.crf_bwd(x, mask, trans, b, alphas, log_z, g)),
        dict(checks=lambda: base_checks("crf_viterbi", a=(a, (C,)),
                                        b=(b, (C,))),
             alloc=lambda: (torch.empty((B, T, C), dtype=torch.int32,
                                        device=dev),
                            torch.empty((B, T), dtype=torch.int32,
                                        device=dev),
                            torch.empty((B,), device=dev)),
             guard_stream=guard_stream,
             ctypes_call=lambda keep=(ptr, path, score): o_vit(*ov_args),
             whole=lambda: _crf_viterbi_scratch(x, mask, trans, a, b)),
        dict(checks=lambda: CRF._check("crf_viterbi", x, mask, trans,
                                       (("a", a, vec), ("b", b, vec))),
             alloc=lambda: (torch.empty((B, T), dtype=torch.int32,
                                        device=dev),
                            torch.empty((B,), device=dev)),
             guard_stream=now_stream,
             ctypes_call=lambda keep=(path, score): f_vit(*vit_args),
             whole=lambda: CRF.crf_viterbi(x, mask, trans, a, b)))


def check_crf_host_split():
    """The host split (``_split_us``: median of 5 interleaved rounds of 400
    calls) of the three wrappers' launch paths at the tagger's training
    and serving shapes, the earlier spelling replayed beside today's."""
    rows = []
    for B, T, C in CRF_SHAPES[:2]:
        x, mask, trans, a, b, g = _crf_inputs(B, T, C, 7)
        alphas, log_z = CRF.crf_alpha_fwd(x, mask, trans, a, b)
        base_b, now_b, base_v, now_v = _crf_pieces(x, mask, trans, a, b,
                                                   alphas, log_z, g)
        base_f, now_f = _crf_fwd_pieces(x, mask, trans, a, b)
        got = _split_us(dict(fwd_baseline=(False, base_f),
                             fwd_now=(False, now_f),
                             bwd_baseline=(False, base_b),
                             bwd_now=(False, now_b),
                             viterbi_baseline=(False, base_v),
                             viterbi_now=(False, now_v)))
        row = dict(B=B, T=T, C=C, **{f"host_us_{k}": v
                                     for k, v in got.items()})
        phase("crf_host_split", **row)
        rows.append(row)
    return rows


def check_crf_kernels():
    """The CRF kernels at CRF_SHAPES and CRF_BIG_SHAPES, after the chain
    floor at each of their class counts."""
    Cs = sorted({C for _, _, C in CRF_SHAPES + CRF_BIG_SHAPES})
    floors = {(C, v): _crf_floor_us(C, v) for C in Cs
              for v in CRF.FLOOR_VARIANTS}
    phase("crf_chain_floor", steps=CRF_FLOOR_STEPS, us_a_step={
        f"C{C}_{v}": us for (C, v), us in floors.items()})
    return [check_crf_shape(B, T, C, B + T + C, floors)
            for B, T, C in CRF_SHAPES + CRF_BIG_SHAPES]


def check_tagger_lstm_kernels():
    """The LSTM kernels at the tagger's shapes (H=128: the JAX package's
    resident-weight ``_lstm_kernel`` at this width): primal in both
    directions at the test pass's (64, 80) and at TAG_SERVE_SHAPES, the
    residual forward with the backward step at (64, 80)."""
    return dict(
        primal=[check_shape(B, TAGGER["hidden"], T, (False, True), seed=B + T)
                for B, T in [(TAG_BATCH, TAG_LEN), *TAG_SERVE_SHAPES]],
        train=check_train_shape(TAG_BATCH, TAGGER["hidden"], TAG_LEN,
                                seed=TAG_LEN + 1))


def crf_kernels():
    """``--crf-kernels``: phase 6's CRF part alone (every CRF_SHAPES and
    CRF_BIG_SHAPES row, the chain floors of the three variants, the
    earlier kernels, the host split of the three wrappers); rows in
    ``crf_kernels.json`` in ``OUT_DIR``."""
    build.build_all(["crf"])
    out = dict(crf_shapes=check_crf_kernels(),
               crf_host_split=check_crf_host_split())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "crf_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)


# -------------------------------------------------- 6b. CTC kernel check
def _ctc_inputs(B, T, L, seed):
    """The CTC kernels' operands from random log-probs [B,T,C] (C = 29,
    blank 28) and labels: frames uniform in T/4..T (row 0 full, the others
    with a padded tail), transcripts of T/10..T/6 characters; with B > 1,
    row 1 an empty transcript, row 2 letters in pairs (repeated labels
    take no jump), row 3 infeasible (L characters in L/2 frames). Returns
    (gathered operands, g, log_probs, labels (int64; the padded slots
    random ids), label_mask, lab_lens, in_lens)."""
    from paddle_tpu_torch.layers.chain import extended_labels
    C = DS2["chars"] + 1
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    log_probs = torch.log_softmax(logits.cuda(), dim=-1)
    in_lens = rng.integers(T // 4, T + 1, size=B)
    in_lens[0] = T
    lab_lens = np.minimum(rng.integers(in_lens // 10, in_lens // 6 + 1), L)
    labels = rng.integers(0, C - 1, size=(B, L))
    if B > 1:
        lab_lens[1] = 0
        labels[2, 1::2] = labels[2, 0::2][:L // 2]
        in_lens[2], lab_lens[2] = T, L
        in_lens[3], lab_lens[3] = max(L // 2, 1), L
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32)).cuda()
    label_mask = torch.from_numpy((np.arange(L)[None, :] < lab_lens[:, None])
                                  .astype(np.float32)).cuda()
    labels = torch.from_numpy(labels).cuda()
    ext, ext_lens, valid_s, can_skip = extended_labels(labels, label_mask,
                                                       C - 1)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, L * 2 + 1))
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
    ops = (emit.contiguous(), in_mask, valid_s.float().contiguous(),
           can_skip.float().contiguous(), ext_lens.contiguous())
    return ops, g, log_probs, labels, label_mask, lab_lens, in_lens


def _ctc_bounds(B, T, S, C, in_lens, ext_lens):
    """Least times of the kernels for this run's data, bytes or
    operations, whichever is larger. Only the valid states (s < ext_lens)
    of the live frames are read: an alpha is frozen on a padded frame and
    NEG past ext_lens whatever the emission, beta_t reads emit_{t+1} only
    where frame t+1 is real, and demit_t is 0 where frame t is padding.
    Bytes: the gathered forward reads emit on frame 0's first two states
    and on every later live frame, the masks and the lengths, and writes
    every alpha and ll; its backward reads emit on the live frames after
    the first, the alphas on every live frame, the masks, lengths, ll and
    g, and writes every demit. The fused forward reads the same emissions
    from the log-probs (twice in training: both chains), the labels
    (8 bytes) and both masks, and writes ll (and in training every alpha
    and beta); the posterior pass reads the alphas and betas of the live
    frames' valid states, the labels, masks, ll and g, and writes every
    d log_probs. Operations: ~15 per live frame and valid state for a
    chain's three-term log-sum-exp and the emission add, 5 more per
    state and frame for the posterior, 1 for its class sum."""
    rows = [(max(int(t), 1), int(e)) for t, e in zip(in_lens, ext_lens)]
    live = float(sum((t - 1) * e for t, e in rows))
    post = float(sum(t * e for t, e in rows))
    small = 4 * (B * T + 2 * B * S + B)
    fwd_in = 4 * sum((t - 1) * e + min(e, 2) for t, e in rows)
    bwd_in = 4 * sum((t - 1) * e + t * e for t, e in rows)
    L = (S - 1) // 2
    fused_small = 4 * B * T + 12 * B * L
    return {
        "fwd": _bound(15.0 * live, fwd_in + small + 4 * (B * T * S + B)),
        "bwd": _bound(15.0 * live + 5.0 * B * T * S,
                      bwd_in + small + 8 * B + 4 * B * T * S),
        "fused_fwd": _bound(30.0 * live, 2 * fwd_in + fused_small
                            + 4 * B + 8 * B * T * S),
        "fused_fwd_nograd": _bound(15.0 * live,
                                   fwd_in + fused_small + 4 * B),
        "fused_bwd": _bound(6.0 * post, 8 * post + fused_small + 8 * B
                            + 4 * B * T * C)}


def _chain_floor_us(P, beta, frames=100000):
    """The chain's least time a frame, us: CUDA events around one launch
    of ``ctc_chain_floor`` (one warp, P states a lane, ``frames`` frames
    of the step and the lane exchange, no global memory), median of 5,
    over ``frames``."""
    return 1e3 * _time_ms(lambda: CTC.ctc_chain_floor(frames, P, beta),
                          reps=5, warmup=1) / frames


def _ctc_library(log_probs, labels, label_mask, in_lens, lab_lens, C):
    """The library yardstick: ``torch.nn.functional.ctc_loss`` on the same
    log-probs [T,B,C] (never on the port's path), forward and backward
    times and the CUDA kernels it ran (their names say which of its
    implementations ran: cuDNN's takes blank 0 only); beside it the port's
    own path over the same span, ``layers/chain.py:ctc_loss`` from the
    log-probs [B,T,C] (the fused kernels: both chains forward, the
    posterior pass backward), and the spelling of ``ctc_loss`` before
    them (``_baseline_ctc_loss``: the extended labels, the gather and the
    gathered kernels, the gather's scatter-add backward), the CUDA kernels
    of the port's path (forward and backward, 5 calls), and the no-grad
    forward. Each side takes log-probs and gives the loss per row and its
    gradient with respect to the log-probs."""
    from paddle_tpu_torch.layers.chain import ctc_loss
    lp = log_probs.transpose(0, 1).detach().requires_grad_(True)
    args = (labels, torch.from_numpy(in_lens), torch.from_numpy(lab_lens))
    T = log_probs.shape[1]
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32)).cuda()
    port_lp = log_probs.detach().requires_grad_(True)
    base_lp = log_probs.detach().requires_grad_(True)
    masks = (in_mask, label_mask)

    def fwd():
        return torch.nn.functional.ctc_loss(lp, *args, blank=C - 1,
                                            reduction="none")

    def port_fwd():
        return ctc_loss(port_lp, labels, *masks, C - 1)

    def base_fwd():
        return _baseline_ctc_loss(base_lp, labels, *masks, C - 1)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda_keys = []
    for run, leaf, must in ((fwd, lp, ()),
                            (port_fwd, port_lp, ("ctc_fused_fwd_kernel",
                                                 "ctc_fused_bwd_kernel"))):
        run()
        torch.cuda.synchronize()
        # the CUDA kernels of 5 forward and backward calls, the union of up
        # to three traces (the profiler drops a launch now and then)
        keys = set()
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(5):
                    torch.autograd.grad(run().sum(), leaf)
                torch.cuda.synchronize()
            keys |= {e.key for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA}
            if all(any(m in k for k in keys) for m in must):
                break
        cuda_keys.append(sorted(keys))
    names = [k for k in cuda_keys[0] if "ctc" in k.lower()]
    out, port_out, base_out = fwd(), port_fwd(), base_fwd()
    ones = torch.ones_like(out)
    row = dict(library_kernels=names, path_kernels=cuda_keys[1])
    with torch.no_grad():
        row["fwd_nograd_port_path_ms"] = _time_ms(port_fwd)
    for name, f, o, leaf in (("library", fwd, out, lp),
                             ("port_path", port_fwd, port_out, port_lp),
                             ("baseline_path", base_fwd, base_out, base_lp)):
        row[f"fwd_{name}_ms"] = _time_ms(f)
        row[f"bwd_{name}_ms"] = _time_ms(lambda: torch.autograd.grad(
            o, leaf, ones, retain_graph=True))
    return row, out.detach()


def _baseline_ctc_loss(log_probs, labels, in_mask, label_mask, blank):
    """``layers/chain.py:ctc_loss`` as it was spelt before the fused
    kernels, replayed for the comparison: the extended labels, the
    [B,T,S] gather, the casts and ``ctc_ll`` (the gathered kernels)."""
    from paddle_tpu_torch.layers.chain import extended_labels
    B, T, _ = log_probs.shape
    ext, ext_lens, valid_s, can_skip = extended_labels(labels, label_mask,
                                                       blank)
    emit = torch.gather(log_probs, 2,
                        ext[:, None, :].expand(B, T, ext.shape[1]))
    dt = log_probs.dtype
    return -CTC.ctc_ll(emit, in_mask.to(dt), valid_s.to(dt), can_skip.to(dt),
                       ext_lens)


def _ctc_check(where, name, got, want):
    """got within rtol 1e-4 / atol 1e-5 of want, their NEG entries equal
    and every entry finite; returns the max abs error."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{where}: {name} is not finite")
    neg = want < -1e29
    if not (torch.equal(got[neg], want[neg]) and (got[~neg] > -1e29).all()):
        raise AssertionError(f"{where}: {name}'s NEG entries differ")
    torch.testing.assert_close(got[~neg], want[~neg], **TOL,
                               msg=lambda m: f"{where} {name}: {m}")
    return (got[~neg] - want[~neg]).abs().max().item() if (~neg).any() \
        else 0.0


def check_ctc_shape(B, T, L, seed, floors):
    """Both operand forms of the CTC kernels against their plain versions
    on the same card tensors. Gathered: ``ctc_alpha_fwd`` and ``ctc_bwd``
    against ``ctc_forward_plain`` and ``ctc_bwd_plain``. Fused:
    ``ctc_fused_fwd`` (both chains) and ``ctc_fused_bwd`` against
    ``ctc_fused_forward_plain`` and ``ctc_fused_bwd_plain``. Alphas,
    betas and ll within rtol 1e-4 / atol 1e-5 (their NEG entries equal),
    the gradients within 1e-4 of their largest entry + 1e-5, every output
    finite, two backward runs bit-equal, the no-grad forward's ll the
    same bits, -ll on the feasible rows within 1e-4 relative of
    ``torch.nn.functional.ctc_loss``; times (device, events, plain), the
    bounds and the chain bound (``floors``: us a frame by (P, beta))."""
    C = DS2["chars"] + 1
    ops, g, log_probs, labels, label_mask, lab_lens, in_lens = _ctc_inputs(
        B, T, L, seed)
    S = 2 * L + 1
    where = f"CTC B={B} T={T} S={S}"
    alphas, ll = CTC.ctc_alpha_fwd(*ops)
    demit = CTC.ctc_bwd(*ops, alphas, ll, g)
    f_ll, f_alphas, f_betas = CTC.ctc_fused_fwd(log_probs, labels, ops[1],
                                                label_mask, C - 1, grad=True)
    fused_bwd_args = (labels, ops[1], label_mask, C - 1, C, f_alphas,
                      f_betas, f_ll, g)
    dlp = CTC.ctc_fused_bwd(*fused_bwd_args)
    torch.cuda.synchronize()
    w_alphas, w_ll = CTC.ctc_forward_plain(*ops)
    fwd_err = max(_ctc_check(where, n, got, want) for n, got, want in (
        ("alphas", alphas, w_alphas), ("ll", ll, w_ll)))
    w_demit = CTC.ctc_bwd_plain(*ops, w_alphas, w_ll, g)
    if not torch.isfinite(demit).all():
        raise AssertionError(f"{where}: demit is not finite")
    bwd_err = _check_grads(where, (demit,), (w_demit,), ("emit",))
    if not torch.equal(demit, CTC.ctc_bwd(*ops, alphas, ll, g)):
        raise AssertionError(f"{where}: two backward runs differ")
    fw_alphas, fw_betas, fw_ll = CTC.ctc_fused_forward_plain(
        log_probs, labels, ops[1], label_mask, C - 1)
    fused_fwd_err = max(_ctc_check(where, "fused " + n, got, want)
                        for n, got, want in (
                            ("alphas", f_alphas, fw_alphas),
                            ("betas", f_betas, fw_betas), ("ll", f_ll, fw_ll)))
    w_dlp = CTC.ctc_fused_bwd_plain(labels, ops[1], label_mask, C - 1, C,
                                    fw_alphas, fw_betas, fw_ll, g)
    if not torch.isfinite(dlp).all():
        raise AssertionError(f"{where}: d log_probs is not finite")
    fused_bwd_err = _check_grads(where, (dlp,), (w_dlp,), ("log_probs",))
    if not torch.equal(dlp, CTC.ctc_fused_bwd(*fused_bwd_args)):
        raise AssertionError(f"{where}: two fused backward runs differ")
    nograd = lambda: CTC.ctc_fused_fwd(log_probs, labels, ops[1],  # noqa
                                       label_mask, C - 1)
    if not torch.equal(nograd(), f_ll):
        raise AssertionError(f"{where}: the no-grad fused ll differs")
    row = dict(B=B, T=T, L=L, S=S, frames=in_lens.tolist(),
               characters=lab_lens.tolist(), fwd_max_abs_err=fwd_err,
               bwd_max_abs_err=bwd_err, fused_fwd_max_abs_err=fused_fwd_err,
               fused_bwd_max_abs_err=fused_bwd_err, bwd_bit_equal=True,
               plan=CTC.ctc_plan(S, C))
    labs = labels.cpu().numpy()
    repeats = np.array([int((labs[b, 1:n] == labs[b, :n - 1]).sum())
                        if n > 1 else 0 for b, n in enumerate(lab_lens)])
    ok = torch.from_numpy(lab_lens + repeats <= in_lens).cuda()
    lib, nll = _ctc_library(log_probs, labels, label_mask, in_lens,
                            lab_lens, C)
    row.update(lib, feasible_rows=int(ok.sum()),
               infeasible_ll=ll[~ok].tolist(),
               library_max_rel_err=max(
                   ((-x[ok] - nll[ok]).abs() / nll[ok].abs()).max().item()
                   for x in (ll, f_ll)))
    if not row["library_max_rel_err"] <= 1e-4:
        raise AssertionError(f"{where}: ll against F.ctc_loss: {row}")
    # the port's path from the log-probs runs the fused kernels alone: no
    # gather, no scatter, no gathered kernel
    path = " ".join(row["path_kernels"])
    if "ctc_fused_fwd_kernel" not in path \
            or "ctc_fused_bwd_kernel" not in path \
            or any(k in path.lower() for k in ("gather", "scatter",
                                               "ctc_alpha_fwd_kernel",
                                               "ctc_bwd_kernel")):
        raise AssertionError(f"{where}: the path ran {row['path_kernels']}")
    # ms: the kernel's device time (torch.profiler); call_ms: CUDA events
    # around one wrapper call, median of 50; plain_ms: the plain version,
    # median of 10
    fused = (log_probs, labels, ops[1], label_mask, C - 1)
    for kind, kernel, name, call, plain in (
            ("fwd", CTC.ctc_alpha_fwd, "ctc_alpha_fwd_kernel",
             lambda: CTC.ctc_alpha_fwd(*ops),
             lambda: CTC.ctc_forward_plain(*ops)),
            ("bwd", CTC.ctc_bwd, "ctc_bwd_kernel",
             lambda: CTC.ctc_bwd(*ops, alphas, ll, g),
             lambda: CTC.ctc_bwd_plain(*ops, alphas, ll, g)),
            ("fused_fwd", CTC.ctc_fused_fwd, "ctc_fused_fwd_kernel",
             lambda: CTC.ctc_fused_fwd(*fused, grad=True),
             lambda: CTC.ctc_fused_forward_plain(*fused)),
            ("fused_fwd_nograd", CTC.ctc_fused_fwd, "ctc_fused_fwd_kernel",
             nograd, None),
            ("fused_bwd", CTC.ctc_fused_bwd, "ctc_fused_bwd_kernel",
             lambda: CTC.ctc_fused_bwd(*fused_bwd_args),
             lambda: CTC.ctc_fused_bwd_plain(*fused_bwd_args))):
        row[f"{kind}_ms"], row[f"{kind}_trace"] = _device_ms(call, name)
        row[f"{kind}_call_ms"] = _time_ms(call, reps=50)
        if plain is not None:
            row[f"{kind}_plain_ms"] = _time_ms(plain, reps=3, warmup=1)
    row["fused_bwd_library_ms"] = row["bwd_library_ms"]
    row["fused_fwd_library_ms"] = row["fwd_library_ms"]
    for kind, (bound_ms, bound_by) in _ctc_bounds(
            B, T, S, C, in_lens, ops[4].tolist()).items():
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms, bound_by
    # the chain bound: the most live frames of any row (the alpha chain's
    # frames 1.. with a real frame, the beta chain's the same in reverse)
    # times the floor of a frame at this S's states a lane
    P = row["plan"]["per_lane"]
    live = int(max(int(n) - 1 for n in in_lens))
    row.update(chain_live_frames=live,
               chain_floor_us_alpha=floors[P, False],
               chain_floor_us_beta=floors[P, True])
    row["fwd_chain_bound_ms"] = 1e-3 * live * floors[P, False]
    row["bwd_chain_bound_ms"] = 1e-3 * live * floors[P, True]
    row["fused_fwd_nograd_chain_bound_ms"] = row["fwd_chain_bound_ms"]
    row["fused_fwd_chain_bound_ms"] = max(row["fwd_chain_bound_ms"],
                                          row["bwd_chain_bound_ms"])
    phase("ctc_kernel_check", **{k: v for k, v in row.items()
                                 if not k.endswith("_trace")})
    return row


def check_ctc_kernels():
    # the floor at 1, 2 and 4 states a lane (the shapes here take 1): what a
    # lane's further states cost on the chain
    floors = {(P, beta): _chain_floor_us(P, beta)
              for P in (1, 2, 4) for beta in (False, True)}
    phase("ctc_chain_floor", us_a_frame={f"P{P}_{'beta' if b else 'alpha'}":
                                         v for (P, b), v in floors.items()})
    return [check_ctc_shape(B, T, L, B + T + L, floors)
            for B, T, L in CTC_SHAPES]


def _ctc_pieces(log_probs, labels, in_mask, label_mask, blank, g):
    """The host split of the fused wrappers' launch paths, piece by piece
    and whole (today's), and of ``ctc_loss``'s spelling before them (the
    baseline: the extended labels, the gather, the casts, per-tensor
    checks, a device guard and ``current_stream()``, the gathered kernel;
    backward: the gathered kernel and the gather's scatter-add):
    (fwd baseline, fwd now, bwd baseline, bwd now) groups for
    ``_split_us``."""
    from paddle_tpu_torch.layers.chain import extended_labels
    B, T, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    idx = log_probs.get_device()
    ll, alphas, betas = CTC.ctc_fused_fwd(log_probs, labels, in_mask,
                                          label_mask, blank, grad=True)
    ext, ext_lens, valid_s, can_skip = extended_labels(labels, label_mask,
                                                       blank)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))
    g_ops = (emit, in_mask, valid_s.float(), can_skip.float(), ext_lens)
    g_alphas, g_ll = CTC.ctc_alpha_fwd(*g_ops)
    f_fwd = build.bind("ctc", "ctc_fused_fwd", 8, 7)
    f_bwd = build.bind("ctc", "ctc_fused_bwd", 9, 8)
    a_fwd = build.bind("ctc", "ctc_alpha_fwd", 7, 3)
    a_bwd = build.bind("ctc", "ctc_bwd", 10, 3)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(B, device=dev)
    dlp = torch.empty(B, T, C, device=dev)
    demit = torch.empty(B, T, S, device=dev)
    fwd_args = (log_probs.data_ptr(), labels.data_ptr(), in_mask.data_ptr(),
                label_mask.data_ptr(), None, None, out.data_ptr(), None, B,
                T, L, C, blank, 1, 1, stream)
    bwd_args = (labels.data_ptr(), in_mask.data_ptr(),
                label_mask.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
                ll.data_ptr(), g.data_ptr(), dlp.data_ptr(), None, B, T, L,
                C, blank, 1, 1, 1, stream)
    gf_args = tuple(t.data_ptr() for t in g_ops) + (
        g_alphas.data_ptr(), out.data_ptr(), B, T, S, stream)
    gb_args = tuple(t.data_ptr() for t in g_ops) + (
        g_alphas.data_ptr(), g_ll.data_ptr(), g.data_ptr(),
        demit.data_ptr(), None, B, T, S, stream)

    def base_checks(kernel, **more):
        d = build.cuda_device(kernel, emit)
        build.check_tensors(kernel, d, emit=(emit, (B, T, S)),
                            in_mask=(in_mask, (B, T)),
                            valid_s=(g_ops[2], (B, S)),
                            can_skip=(g_ops[3], (B, S)), **more)
        if ext_lens.dtype != torch.int32 or ext_lens.device != d:
            raise ValueError(kernel)

    def guard_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    def base_fwd():
        ext, ext_lens, valid_s, can_skip = extended_labels(labels,
                                                           label_mask, blank)
        e = torch.gather(log_probs, 2,
                         ext[:, None, :].expand(B, T, S)).contiguous()
        ops = (e, in_mask.contiguous(), valid_s.float().contiguous(),
               can_skip.float().contiguous(),
               ext_lens.to(torch.int32).contiguous())
        base_checks("ctc_alpha_fwd")
        a, o = torch.empty((B, T, S), device=dev), torch.empty(B, device=dev)
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream().cuda_stream
            build.raise_on(a_fwd(*(t.data_ptr() for t in ops), a.data_ptr(),
                                 o.data_ptr(), B, T, S, st), "ctc_alpha_fwd")

    def scatter():
        return torch.zeros_like(log_probs).scatter_add_(
            2, ext[:, None, :].expand(B, T, S), demit)

    def base_bwd():
        base_checks("ctc_bwd", alphas=(g_alphas, (B, T, S)), ll=(g_ll, (B,)),
                    g=(g, (B,)))
        d = torch.empty((B, T, S), device=dev)
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream().cuda_stream
            # no scratch: the lanes' route (S <= 16,384) reads none
            build.raise_on(a_bwd(*gb_args[:8], d.data_ptr(), *gb_args[9:13],
                                 st), "ctc_bwd")
        scatter()

    fused = (labels, in_mask, label_mask, blank, C)
    return (
        dict(ext=lambda: extended_labels(labels, label_mask, blank),
             gather=lambda: torch.gather(log_probs, 2,
                                         ext[:, None, :].expand(B, T, S)),
             casts=lambda: (in_mask.to(torch.float32), valid_s.float(),
                            can_skip.float(), ext_lens.to(torch.int32)),
             checks=lambda: base_checks("ctc_alpha_fwd"),
             alloc=lambda: (torch.empty((B, T, S), device=dev),
                            torch.empty(B, device=dev)),
             guard_stream=guard_stream,
             ctypes_call=lambda: a_fwd(*gf_args), whole=base_fwd),
        dict(checks=lambda: CTC._check_fused(
                 "ctc_fused_fwd", labels, in_mask, label_mask, blank, C,
                 (("log_probs", log_probs, (B, T, C)),)),
             alloc=lambda: log_probs.new_empty((B,)),
             guard_stream=lambda: (torch.cuda.current_device() == idx,
                                   torch._C._cuda_getCurrentRawStream(idx)),
             ctypes_call=lambda: f_fwd(*fwd_args),
             whole=lambda: CTC.ctc_fused_fwd(log_probs, labels, in_mask,
                                             label_mask, blank)),
        dict(checks=lambda: base_checks("ctc_bwd",
                                        alphas=(g_alphas, (B, T, S)),
                                        ll=(g_ll, (B,)), g=(g, (B,))),
             alloc=lambda: torch.empty((B, T, S), device=dev),
             guard_stream=guard_stream,
             ctypes_call=lambda: a_bwd(*gb_args), scatter=scatter,
             whole=base_bwd),
        dict(checks=lambda: CTC._check_fused(
                 "ctc_fused_bwd", labels, in_mask, label_mask, blank, C,
                 (("alphas", alphas, (B, T, S)), ("betas", betas, (B, T, S)),
                  ("ll", ll, (B,)), ("g", g, (B,)))),
             alloc=lambda: alphas.new_empty((B, T, C)),
             guard_stream=lambda: (torch.cuda.current_device() == idx,
                                   torch._C._cuda_getCurrentRawStream(idx)),
             ctypes_call=lambda: f_bwd(*bwd_args),
             whole=lambda: CTC.ctc_fused_bwd(*fused, alphas, betas, ll, g)))


def check_ctc_host_split():
    """The host split (``_split_us``: median of 5 interleaved rounds of 400
    calls) of both fused wrappers' launch paths at the acoustic model's
    shape (CTC_SHAPES[0]), ``ctc_loss``'s spelling before them replayed
    beside today's, and of ``ctc_loss``'s entries (no grad: the alpha
    chains; training: ``CtcFusedFunction``, its autograd share)."""
    from paddle_tpu_torch.layers.chain import ctc_loss
    B, T, L = CTC_SHAPES[0]
    C = DS2["chars"] + 1
    _, g, log_probs, labels, label_mask, _, in_lens = _ctc_inputs(B, T, L, 5)
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32)).cuda()
    base_f, now_f, base_b, now_b = _ctc_pieces(log_probs, labels, in_mask,
                                               label_mask, C - 1, g)
    leaf = log_probs.detach().clone().requires_grad_(True)
    got = _split_us(dict(
        fwd_baseline=(False, base_f), fwd_now=(False, now_f),
        bwd_baseline=(False, base_b), bwd_now=(False, now_b),
        infer=(False, dict(infer_entry=lambda: ctc_loss(
            log_probs, labels, in_mask, label_mask, C - 1))),
        train=(True, dict(train_entry=lambda: ctc_loss(
            leaf, labels, in_mask, label_mask, C - 1)))))
    row = dict(B=B, T=T, L=L, host_us_fwd_baseline=got["fwd_baseline"],
               host_us_fwd=got["fwd_now"],
               host_us_bwd_baseline=got["bwd_baseline"],
               host_us_bwd=got["bwd_now"],
               host_us_entry=dict(
                   infer_entry=got["infer"]["infer_entry"],
                   train_entry=got["train"]["train_entry"],
                   autograd=got["train"]["train_entry"]
                   - got["infer"]["infer_entry"]))
    phase("ctc_host_split", **row)
    return row


def _profiled_ms(fn, kernel, calls):
    """``_device_ms`` of ``fn`` at ``kernel``, or None where six traces
    hold none of its launches."""
    try:
        return _device_ms(fn, kernel, calls=calls)[0]
    except AssertionError:
        return None


def check_ctc_beyond(B, T, C, L, seed):
    """The fused kernels at a size they refused before (CTC_BEYOND_SHAPES):
    the routes ``ctc_plan`` gives, the forward (both chains) and the
    posterior pass against ``ctc_fused_forward_plain`` and
    ``ctc_fused_bwd_plain`` on the same card tensors (alphas, betas and ll
    within rtol 1e-4 / atol 1e-5 with their NEG entries equal; d log_probs
    within 1e-4 of its largest entry + 1e-5), two backward runs bit-equal,
    the no-grad ll the same bits; the loss (``ctc_ll_from_log_probs``,
    ``negate``, through ``CtcFusedFunction``) and its gradient against the
    plain versions' at phase 11c's tolerances (the loss within 1e-5
    relative, the gradient within 1e-3 of its largest entry + 1e-6). Times: CUDA events around a
    wrapper call and the kernels' device time, the plain versions, and
    ``F.ctc_loss`` forward and backward, beside the bounds."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    blank = C - 1
    log_probs = torch.log_softmax(torch.from_numpy(rng.normal(
        size=(B, T, C)).astype(np.float32)).cuda(), dim=-1)
    in_lens = rng.integers(T // 2, T + 1, size=B)
    in_lens[0] = T
    lab_lens = np.minimum(rng.integers(1, L + 1, size=B), in_lens // 2)
    lab_lens[0] = L
    labels = torch.from_numpy(rng.integers(0, C - 1, size=(B, L))).cuda()
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32)).cuda()
    label_mask = torch.from_numpy((np.arange(L)[None, :]
                                   < lab_lens[:, None])
                                  .astype(np.float32)).cuda()
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
    S = 2 * L + 1
    plan = CTC.ctc_plan(S, C)
    where = f"CTC beyond B={B} T={T} C={C} S={S}"
    fused = (log_probs, labels, in_mask, label_mask, blank)
    before = (CTC.ctc_fused_fwd.launches, CTC.ctc_fused_bwd.launches)
    ll, alphas, betas = CTC.ctc_fused_fwd(*fused, grad=True)
    bwd_args = (labels, in_mask, label_mask, blank, C, alphas, betas, ll, g)
    dlp = CTC.ctc_fused_bwd(*bwd_args)
    torch.cuda.synchronize()
    if (CTC.ctc_fused_fwd.launches, CTC.ctc_fused_bwd.launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError(f"{where}: the wrappers did not launch")
    plain_ms = {}  # each plain version once: host clock to a synchronise

    def timed(kind, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain_ms[kind] = 1e3 * (time.perf_counter() - t0)
        return out

    w_alphas, w_betas, w_ll = timed(
        "fused_fwd", lambda: CTC.ctc_fused_forward_plain(*fused))
    fwd_err = max(_ctc_check(where, n, got, want) for n, got, want in (
        ("alphas", alphas, w_alphas), ("betas", betas, w_betas),
        ("ll", ll, w_ll)))
    fwd_bits = all(torch.equal(a, b) for a, b in (
        (alphas, w_alphas), (betas, w_betas), (ll, w_ll)))
    w_dlp = timed("fused_bwd", lambda: CTC.ctc_fused_bwd_plain(
        labels, in_mask, label_mask, blank, C, w_alphas, w_betas, w_ll, g))
    if not torch.isfinite(dlp).all():
        raise AssertionError(f"{where}: d log_probs is not finite")
    bwd_err = _check_grads(where, (dlp,), (w_dlp,), ("log_probs",))
    if not torch.equal(dlp, CTC.ctc_fused_bwd(*bwd_args)):
        raise AssertionError(f"{where}: two backward runs differ")
    if not torch.equal(CTC.ctc_fused_fwd(*fused), ll):
        raise AssertionError(f"{where}: the no-grad ll differs")
    del w_alphas, w_betas
    # the loss (-ll, the sign taken in the kernels) and its gradient
    # through CtcFusedFunction, against the plain values: -w_ll, and
    # -w_dlp (the plain pass is linear in g, and a sign flip is exact)
    leaf = log_probs.detach().clone().requires_grad_(True)
    loss = CTC.ctc_ll_from_log_probs(leaf, labels, in_mask, label_mask,
                                     blank, negate=True)
    grad, = torch.autograd.grad((loss * g).sum(), leaf)
    loss_err = ((loss.detach() + w_ll).abs()
                / w_ll.abs().clamp_min(1e-30)).max().item()
    grad_err = (grad + w_dlp).abs().max().item()
    if not (loss_err <= 1e-5
            and grad_err <= 1e-3 * w_dlp.abs().max().item() + 1e-6):
        raise AssertionError(f"{where}: loss rel err {loss_err}, gradient "
                             f"err {grad_err} against the plain versions")
    del leaf, loss, grad, w_dlp
    names = {"fwd": ("ctc_fused_wide_kernel" if plan["fwd"] == "wide"
                     else "ctc_fused_fwd_kernel"),
             "bwd": (("ctc_class_order_kernel", "ctc_fused_bwd_sorted_kernel")
                     if plan["bwd"] == "sorted" else "ctc_fused_bwd_kernel")}
    row = dict(B=B, T=T, C=C, L=L, S=S, frames=in_lens.tolist(),
               characters=lab_lens.tolist(), plan=plan,
               fused_fwd_max_abs_err=fwd_err, fused_fwd_bit_equal=fwd_bits,
               fused_bwd_max_abs_err=bwd_err, bwd_bit_equal=True,
               loss_rel_err=loss_err, loss_grad_max_abs_err=grad_err)
    reps = 3 if T > 1000 else 10
    for kind, call in (
            ("fused_fwd", lambda: CTC.ctc_fused_fwd(*fused, grad=True)),
            ("fused_bwd", lambda: CTC.ctc_fused_bwd(*bwd_args))):
        # ms: CUDA events around a call (one launch, or two on the sorted
        # route); device_ms: torch.profiler, null where its traces hold
        # none of the kernels
        row[f"{kind}_ms"] = _time_ms(call, reps=reps, warmup=1)
        row[f"{kind}_device_ms"] = _profiled_ms(call, names[kind[6:]], reps)
        row[f"{kind}_plain_ms"] = plain_ms[kind]
    lp_t = log_probs.detach().transpose(0, 1).requires_grad_(True)
    lib_args = (labels, torch.from_numpy(in_lens), torch.from_numpy(lab_lens))

    def lib_fwd():
        return torch.nn.functional.ctc_loss(lp_t, *lib_args, blank=blank,
                                            reduction="none")

    lib_out = lib_fwd()
    row["fused_fwd_library_ms"] = _time_ms(lib_fwd, reps=reps, warmup=1)
    row["fused_bwd_library_ms"] = _time_ms(lambda: torch.autograd.grad(
        lib_out, lp_t, g, retain_graph=True), reps=reps, warmup=1)
    ext_lens = (2 * label_mask.sum(dim=1) + 1).int().tolist()
    for kind, (bound_ms, bound_by) in _ctc_bounds(
            B, T, S, C, in_lens, ext_lens).items():
        if kind.startswith("fused_") and kind != "fused_fwd_nograd":
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = (bound_ms,
                                                                bound_by)
    row["seconds"] = time.perf_counter() - t0
    phase("ctc_beyond_check", **row)
    return row


def check_ctc_beyond_shapes():
    return [check_ctc_beyond(B, T, C, L, B + T + C + L)
            for B, T, C, L in CTC_BEYOND_SHAPES]


def check_ctc_gathered_beyond(B, T, C, L, seed):
    """The gathered kernels (``ctc_alpha_fwd``, ``ctc_bwd``: JAX's operands)
    at S = 2 L + 1 above the lanes' 16,384 states, where they refused
    before (CTC_GATHERED_BEYOND): the wide route (``ctc_gathered_wide_
    kernel``) against ``ctc_forward_plain`` and ``ctc_bwd_plain`` (alphas
    and ll within rtol 1e-4 / atol 1e-5, NEG entries equal; demit within
    1e-4 of its largest entry + 1e-5; and whether the bits are equal),
    two backward runs bit-equal, and against the fused form on the same
    inputs (its alphas and ll; its d log_probs against demit summed per
    class, ``class_sums_plain``). The transcript is shorter than the
    padded L (the frames must hold it): the states past it are valid_s 0,
    as a padded batch has them. Times as in ``check_ctc_beyond``."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    blank = C - 1
    log_probs = torch.log_softmax(torch.from_numpy(rng.normal(
        size=(B, T, C)).astype(np.float32)).cuda(), dim=-1)
    in_lens = rng.integers(T // 2, T + 1, size=B)
    in_lens[0] = T
    lab_lens = rng.integers(T // 4, T // 2, size=B)
    labels = torch.from_numpy(rng.integers(0, C - 1, size=(B, L))).cuda()
    in_mask = torch.from_numpy((np.arange(T)[None, :] < in_lens[:, None])
                               .astype(np.float32)).cuda()
    label_mask = torch.from_numpy((np.arange(L)[None, :]
                                   < lab_lens[:, None])
                                  .astype(np.float32)).cuda()
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
    emit, valid_s, can_skip, ext_lens, ext = CTC._fused_operands(
        log_probs, labels, label_mask, blank)
    S = emit.shape[2]
    where = f"CTC gathered beyond B={B} T={T} S={S}"
    if CTC.ctc_plan(S)["fwd"] != "wide":
        raise AssertionError(f"{where}: not on the wide route")
    args = (emit.contiguous(), in_mask, valid_s.contiguous(),
            can_skip.contiguous(), ext_lens.contiguous())
    before = (CTC.ctc_alpha_fwd.launches, CTC.ctc_bwd.launches)
    alphas, ll = CTC.ctc_alpha_fwd(*args)
    demit = CTC.ctc_bwd(*args, alphas, ll, g)
    torch.cuda.synchronize()
    if (CTC.ctc_alpha_fwd.launches, CTC.ctc_bwd.launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError(f"{where}: the wrappers did not launch")
    plain_ms = {}

    def timed(kind, fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain_ms[kind] = 1e3 * (time.perf_counter() - t1)
        return out

    w_alphas, w_ll = timed("fwd", lambda: CTC.ctc_forward_plain(*args))
    fwd_err = max(_ctc_check(where, n, got, want) for n, got, want in (
        ("alphas", alphas, w_alphas), ("ll", ll, w_ll)))
    w_demit = timed("bwd", lambda: CTC.ctc_bwd_plain(*args, w_alphas, w_ll,
                                                     g))
    if not torch.isfinite(demit).all():
        raise AssertionError(f"{where}: demit is not finite")
    bwd_err = _check_grads(where, (demit,), (w_demit,), ("emit",))
    if not torch.equal(demit, CTC.ctc_bwd(*args, alphas, ll, g)):
        raise AssertionError(f"{where}: two backward runs differ")
    bits = dict(fwd=bool(torch.equal(alphas, w_alphas)
                         and torch.equal(ll, w_ll)),
                bwd=bool(torch.equal(demit, w_demit)))
    del w_alphas, w_demit
    # the fused form on the same inputs
    f_ll, f_alphas, f_betas = CTC.ctc_fused_fwd(
        log_probs, labels, in_mask, label_mask, blank, grad=True)
    fused_err = max(_ctc_check(where + " vs fused", n, got, want)
                    for n, got, want in (("alphas", alphas, f_alphas),
                                         ("ll", ll, f_ll)))
    f_dlp = CTC.ctc_fused_bwd(labels, in_mask, label_mask, blank, C,
                              f_alphas, f_betas, f_ll, g)
    del f_alphas, f_betas
    summed = CTC.class_sums_plain(demit, ext, C)
    fused_grad_err = _check_grads(where + " vs fused", (summed,), (f_dlp,),
                                  ("log_probs",))
    row = dict(B=B, T=T, C=C, L=L, S=S, frames=in_lens.tolist(),
               characters=lab_lens.tolist(), plan=CTC.ctc_plan(S),
               fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
               plain_bit_equal=bits, bwd_bit_equal=True,
               fused_max_abs_err=fused_err,
               fused_bit_equal=bool(torch.equal(alphas, CTC.ctc_fused_fwd(
                   log_probs, labels, in_mask, label_mask, blank,
                   grad=True)[1])),
               fused_grad_max_abs_err=fused_grad_err,
               fused_grad_bit_equal=bool(torch.equal(summed, f_dlp)))
    del f_dlp, summed
    for kind, call in (
            ("fwd", lambda: CTC.ctc_alpha_fwd(*args)),
            ("bwd", lambda: CTC.ctc_bwd(*args, alphas, ll, g))):
        row[f"{kind}_ms"] = _time_ms(call, reps=3, warmup=1)
        row[f"{kind}_device_ms"] = _profiled_ms(
            call, "ctc_gathered_wide_kernel", 3)
        row[f"{kind}_plain_ms"] = plain_ms[kind]
    lp_t = log_probs.detach().transpose(0, 1).requires_grad_(True)
    lib_args = (labels, torch.from_numpy(in_lens), torch.from_numpy(lab_lens))

    def lib_fwd():
        return torch.nn.functional.ctc_loss(lp_t, *lib_args, blank=blank,
                                            reduction="none")

    lib_out = lib_fwd()
    row["fwd_library_ms"] = _time_ms(lib_fwd, reps=3, warmup=1)
    row["bwd_library_ms"] = _time_ms(lambda: torch.autograd.grad(
        lib_out, lp_t, g, retain_graph=True), reps=3, warmup=1)
    for kind, (bound_ms, bound_by) in _ctc_bounds(
            B, T, S, C, in_lens, ext_lens.tolist()).items():
        if kind in ("fwd", "bwd"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = (bound_ms,
                                                                bound_by)
    row["seconds"] = time.perf_counter() - t0
    phase("ctc_gathered_beyond_check", **{k: v for k, v in row.items()
                                         if k not in ("frames",
                                                      "characters")})
    return row


def check_ctc_gathered_beyond_shapes():
    return [check_ctc_gathered_beyond(B, T, C, L, B + T + C + L)
            for B, T, C, L in CTC_GATHERED_BEYOND]


def ctc_kernels():
    """``--ctc-kernels``: phase 6b alone (both operand forms at every
    CTC_SHAPES row with ``F.ctc_loss`` beside them, the chain floor, the
    fused kernels at CTC_BEYOND_SHAPES, the host split of the fused
    wrappers); rows in ``ctc_kernels.json`` in ``OUT_DIR``."""
    build.build_all(["ctc"])
    out = dict(ctc_shapes=check_ctc_kernels(),
               ctc_beyond=check_ctc_beyond_shapes(),
               ctc_gathered_beyond=check_ctc_gathered_beyond_shapes(),
               ctc_host_split=check_ctc_host_split())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ctc_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)


# ------------------------------------------ 7. flash-attention kernel check
def _flash_inputs(B, N, Tq, Tk, D, seed, min_len, pad_row):
    """q, k, v, dO [B,N,T,D] and a kv mask [B,Tk] of lengths min_len..Tk
    (row 0 full; with ``pad_row`` the last all padding, as a batch bucket
    pads it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    lens = torch.randint(min_len, Tk + 1, (B,), generator=g, device="cuda")
    lens[0] = Tk
    if pad_row:
        lens[-1] = 0
    mask = (torch.arange(Tk, device="cuda")[None, :] < lens[:, None]).float()
    return (randn(B, N, Tq, D), randn(B, N, Tk, D), randn(B, N, Tk, D),
            mask.contiguous(), randn(B, N, Tq, D))


def _flash_visible(B, Tq, Tk, mask, causal):
    """[B, Tq, Tk] bool: the (query, key) pairs the mask and causal leave
    visible (``kj <= qi + Tk - Tq``)."""
    vis = (mask[:, None, :] > 0).expand(B, Tq, Tk)
    if causal:
        qi = torch.arange(Tq, device=mask.device)[:, None] + (Tk - Tq)
        vis = vis & (torch.arange(Tk, device=mask.device)[None, :] <= qi)
    return vis


def _flash_bounds(B, N, Tq, Tk, D, visible):
    """Least times of the forward and the backward for these inputs, by
    the pairs this mask and causal leave visible (a row that sees no key
    needs only v's mean): 4 D operations per pair forward (two products),
    10 D backward (five). Bytes: q, k, v, mask in, o and the row
    statistics out; the backward's q, k, v, mask, o, dO and statistics
    in, dq, dk, dv out. Returns {kind: ((ms, by) at the f32 rate, ms of
    the same work in split TF32: three passes of the operations at the
    dense TF32 rate, or the bytes; the operations; the bytes)}."""
    pairs = N * float(visible.sum())
    q_el, kv_el = B * N * Tq * D, B * N * Tk * D
    work = {"fwd": (4.0 * D * pairs,
                    4 * (q_el + 2 * kv_el + B * Tk + q_el + 2 * B * N * Tq)),
            "bwd": (10.0 * D * pairs,
                    4 * (3 * q_el + 2 * kv_el + B * Tk + 2 * B * N * Tq
                         + q_el + 2 * kv_el))}
    return {kind: (_bound(ops, nbytes),
                   1e3 * max(3 * ops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S),
                   ops, nbytes)
            for kind, (ops, nbytes) in work.items()}


def _sdpa(q, k, v, do, scale, **mask):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    (never on the port's path) with ``mask``: the additive -1e9 bias
    [B, 1, Tq, Tk] (``attn_mask=``), ``is_causal=True``, or nothing. The
    first backend, of the fused ones then the math one, that takes these
    inputs forward and backward; returns (call, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(q, k, v, backend=backend):
            with sdpa_kernel(backend):
                return sdpa(q, k, v, scale=scale, **mask)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a backend says why not
                torch.autograd.grad(call(*leaves), leaves, do)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    raise AssertionError("no scaled_dot_product_attention backend ran")


def _library_times(q, k, v, do, w_o, scale, name, **mask):
    """SDPA with ``mask`` (``_sdpa``) at these inputs: its backend, its
    largest error against ``blockwise_plain``'s o, and its forward,
    backward and both by CUDA events (median of 10), the forward and the
    backward also by device time (every CUDA kernel of the call,
    ``torch.profiler``). Keys ``<kind>_<name>_ms``, ``<kind>_<name>
    _device_ms``."""
    call, backend = _sdpa(q, k, v, do, scale, **mask)
    with torch.no_grad():
        row = {f"{name}_backend": backend,
               f"{name}_max_abs_err": (call(q, k, v) - w_o).abs().max()
               .item()}
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd():
        torch.autograd.grad(call(*leaves), leaves, do)

    out = call(*leaves)

    def bwd():
        torch.autograd.grad(out, leaves, do, retain_graph=True)

    row[f"fwd_{name}_ms"] = _time_ms(lambda: call(q, k, v))
    row[f"fwd_{name}_device_ms"] = _device_ms(lambda: call(q, k, v), None,
                                              calls=10)[0]
    row[f"fwd_bwd_{name}_ms"] = _time_ms(fwd_bwd)
    row[f"bwd_{name}_ms"] = _time_ms(bwd)
    row[f"bwd_{name}_device_ms"] = _device_ms(bwd, None, calls=10)[0]
    return row


def check_flash_shape(B, N, Tq, Tk, D, causal, min_len, pad_row, seed):
    """The forward and backward kernels against ``blockwise_plain`` and
    ``flash_bwd_plain`` on the same card tensors (o and the row statistics
    within rtol 1e-4 / atol 1e-5; every gradient per tensor within 1e-4
    of its largest entry + 1e-5), the backward also against autograd
    through ``mha_plain`` where that is the same function (no query row
    that sees no key, or Tk a multiple of JAX's kv block min(256, Tk):
    otherwise JAX, and so the kernels, divide such a row by the padded
    Tk); two backward runs bit-equal; every output finite (an all-padding
    row included). Times: each wrapper call by CUDA events (median of 10)
    and its kernels' device time (``torch.profiler``), the plain
    versions, and SDPA forward, backward and both, beside the bounds. D >
    128 runs the wide-head kernels (their own profiler filters)."""
    q, k, v, mask, do = _flash_inputs(B, N, Tq, Tk, D, seed, min_len,
                                      pad_row)
    o, lse = ATT.flash_fwd(q, k, v, mask, causal)
    grads = ATT.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    where = f"flash B={B} N={N} Tq={Tq} Tk={Tk} D={D} causal={causal}"
    for name, t in (("o", o), ("lse", lse), *zip(("dq", "dk", "dv"), grads)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{where}: {name} is not finite")
    w_o, w_lse = ATT.blockwise_plain(q, k, v, mask, causal)
    fwd_err = 0.0
    for name, got, want in (("o", o, w_o), ("lse", lse, w_lse)):
        fwd_err = max(fwd_err, (got - want).abs().max().item())
        torch.testing.assert_close(got, want, **TOL,
                                   msg=lambda m: f"{where} {name}: {m}")
    names = ("q", "k", "v")
    bwd_err = _check_grads(where, grads, ATT.flash_bwd_plain(
        q, k, v, mask, w_o, w_lse, do, causal), names)
    visible = _flash_visible(B, Tq, Tk, mask, causal)
    no_key_rows = int((~visible.any(dim=-1)).sum())
    ref_err = None
    if no_key_rows == 0 or Tk % min(256, Tk) == 0:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = ATT.mha_plain(*leaves, mask, causal)
        ref_err = _check_grads(f"{where} vs autograd of mha_plain", grads,
                               torch.autograd.grad((ref * do).sum(), leaves),
                               names)
        del ref, leaves
    again = ATT.flash_bwd(q, k, v, mask, o, lse, do, causal)
    if not all(torch.equal(u, w) for u, w in zip(grads, again)):
        raise AssertionError(f"{where}: two backward runs differ")
    scale = D ** -0.5
    path = ATT.flash_plan(ATT.padded_width(D))["variant"]
    fwd_dev = _device_ms(lambda: ATT.flash_fwd(q, k, v, mask, causal),
                         _FLASH_KERNELS[path][0], calls=10)
    bwd_dev = _device_ms(
        lambda: ATT.flash_bwd(q, k, v, mask, o, lse, do, causal),
        _FLASH_KERNELS[path][1], calls=10)
    row = dict(B=B, N=N, Tq=Tq, Tk=Tk, D=D, causal=causal, path=path,
               all_padding_rows=int((mask.sum(dim=1) == 0).sum()),
               no_key_rows=no_key_rows,
               visible_pairs=N * float(visible.sum()),
               fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
               bwd_vs_mha_autograd_err=ref_err, bwd_bit_equal=True,
               fwd_ms=_time_ms(lambda: ATT.flash_fwd(q, k, v, mask, causal)),
               bwd_ms=_time_ms(lambda: ATT.flash_bwd(q, k, v, mask, o, lse,
                                                     do, causal)),
               fwd_device_ms=fwd_dev[0], fwd_device_trace=fwd_dev[1],
               bwd_device_ms=bwd_dev[0], bwd_device_trace=bwd_dev[1],
               fwd_plain_ms=_time_ms(lambda: ATT.blockwise_plain(
                   q, k, v, mask, causal)),
               bwd_plain_ms=_time_ms(lambda: ATT.flash_bwd_plain(
                   q, k, v, mask, w_o, w_lse, do, causal)))
    bias = torch.zeros((B, 1, Tq, Tk), device="cuda").masked_fill(
        ~visible[:, None], -1e9)
    lib = _library_times(q, k, v, do, w_o, scale, "library", attn_mask=bias)
    row.update(lib, sdpa_backend=lib["library_backend"],
               sdpa_max_abs_err=lib["library_max_abs_err"])
    del bias
    if path == "wide":  # the outputs' chunk parts (forward and dq; dkdv)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["wide_parts"] = [ATT.wide_parts(B * N * -(-T // ATT.WIDE_ROWS),
                                            D, sms) for T in (Tq, Tk)]
    if bool((mask > 0).all()) and (not causal or Tq == Tk):
        # the same function without the bias tensor: SDPA's own causal
        # rule (top-left) is ours only for a square causal
        row.update(_library_times(q, k, v, do, w_o, scale, "library_nobias",
                                  **({"is_causal": True} if causal else {})))
    for kind in ("fwd", "bwd"):
        dev = [row[k] for k in (f"{kind}_library_device_ms",
                                f"{kind}_library_nobias_device_ms")
               if k in row]
        row[f"{kind}_library_fastest_device_ms"] = min(dev)
        row[f"{kind}_vs_library_device"] = (
            row[f"{kind}_device_ms"] / min(dev))
    for kind, ((bound_ms, bound_by), tf32, ops, nbytes) in _flash_bounds(
            B, N, Tq, Tk, D, visible).items():
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms, bound_by
        row[f"{kind}_bound_tf32x3_ms"] = tf32
        row[f"{kind}_ops"], row[f"{kind}_bytes"] = ops, nbytes
    phase("flash_kernel_check", **row)
    return row


# the profiler's filters of each path's kernels: (forward, backward) by
# ``flash_plan``'s variant
_FLASH_KERNELS = {"tensor_cores": ("flash_fwd_kernel", "flash_bwd_"),
                  "wide": ("flash_wide_fwd_kernel", "flash_wide_d"),
                  "split": ("flash_split_fwd_kernel",
                            ("flash_split_dq_kernel",
                             "flash_split_dkdv_kernel"))}


def check_flash_kernels():
    """Every FLASH_SHAPES row on the tensor-core kernels, every
    FLASH_WIDE_SHAPES row on the wide-head path, every FLASH_SPLIT_SHAPES
    row on the split-row path."""
    rows = []
    for shape in FLASH_SHAPES + FLASH_WIDE_SHAPES + FLASH_SPLIT_SHAPES:
        t0 = time.perf_counter()
        rows.append(check_flash_shape(*shape, seed=sum(shape[:5])))
        rows[-1]["seconds"] = time.perf_counter() - t0
    return rows


def check_wide_attention_layer():
    """``multi_head_attention`` at WIDE_LAYER (size 512, 2 heads: D = 256,
    the wide-head path) forward and backward on the card against the same
    layer on the CPU (its plain versions) in float64, from the same random
    weights and inputs (lengths 50, 31, 7 and an all-padding row; the f32
    values widened exactly): y within rtol 1e-4 / atol 1e-5, every
    parameter gradient per tensor within 1e-4 of its largest entry + 1e-5;
    one launch of each flash wrapper. The reference is float64 because
    the CPU's float32 forward of this layer is not repeatable: on the
    card's host one process's first forward read 5.3e-5 from its second
    (whose values the card matched within 1.7e-6), and here 3 of 22
    processes read 3.8e-5 from the float64 forward, the others 1.5e-6
    (ROADMAP Queue 3)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.argument import Argument
    from paddle_tpu_torch.core.network import Network
    size, heads = WIDE_LAYER["size"], WIDE_LAYER["num_heads"]
    B, T = WIDE_LAYER["batch"], WIDE_LAYER["steps"]
    dsl.reset()
    x = dsl.data(name="x", size=size, is_sequence=True)
    out = dsl.multi_head_attention(x, size=size, num_heads=heads,
                                   name="att_wide")
    net = Network(dsl.current_graph(), outputs=[out.name])
    rng = np.random.default_rng(SEED)
    params = {k: rng.normal(size=s.shape).astype(np.float32) * size ** -0.5
              for k, s in net.param_specs.items()}
    lens = np.array([T, 31, 7, 0])[:B]
    mask = torch.from_numpy((np.arange(T)[None, :] < lens[:, None])
                            .astype(np.float32))
    xv = torch.from_numpy(rng.normal(size=(B, T, size)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(B, T, size)).astype(np.float32))
    results, launches = [], None
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        p = {k: torch.from_numpy(v).to(dev, dt).requires_grad_(True)
             for k, v in params.items()}
        before = (ATT.flash_fwd.launches, ATT.flash_bwd.launches)
        y = net.apply(p, {"x": Argument(xv.to(dev, dt), mask.to(dev, dt))})[
            out.name].value
        gs = torch.autograd.grad((y * ct.to(dev, dt)).sum(),
                                 list(p.values()))
        torch.cuda.synchronize()
        if dev == "cuda":
            launches = (ATT.flash_fwd.launches - before[0],
                        ATT.flash_bwd.launches - before[1])
        results.append((y.detach().cpu().float(),
                        [g.cpu().float() for g in gs]))
    (y_cpu, g_cpu), (y_gpu, g_gpu) = results
    where = f"multi_head_attention size={size} heads={heads}"
    try:
        torch.testing.assert_close(y_gpu, y_cpu, **TOL,
                                   msg=lambda m: f"{where} y: {m}")
    except AssertionError:
        _diagnose_wide_layer(net, out.name, params, xv, mask, y_gpu, y_cpu,
                             heads)
        raise
    if launches != (1, 1):
        raise AssertionError(f"{where}: flash launches {launches}")
    row = dict(size=size, num_heads=heads, head_width=size // heads, B=B,
               T=T, y_max_abs_err=(y_gpu - y_cpu).abs().max().item(),
               grad_max_abs_err=_check_grads(where, g_gpu, g_cpu,
                                             list(params)),
               flash_launches=launches)
    phase("flash_wide_layer_check", **row)
    return row


def _host_cpu():
    """The host CPU the CPU references run on: its model name (from
    /proc/cpuinfo), PyTorch's CPU capability (the vector ISA its kernels
    dispatch to) and thread count."""
    name = None
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), None)
    return dict(model=name,
                capability=torch.backends.cpu.get_cpu_capability(),
                threads=torch.get_num_threads())


def check_wide_attention_layers(repeats):
    """``check_wide_attention_layer`` ``repeats`` times over, each repeat
    anew on both devices; a failing repeat prints its diagnosis and the
    rest still run. Raises after the last repeat if any failed; returns
    the repeats' rows and the host CPU."""
    rows, failures = [], []
    for i in range(repeats):
        try:
            rows.append(check_wide_attention_layer())
        except AssertionError as e:
            failures.append(dict(repeat=i, error=str(e)[:400]))
    out = dict(repeats=repeats, failed=len(failures), failures=failures,
               host_cpu=_host_cpu(),
               y_max_abs_err=max((r["y_max_abs_err"] for r in rows),
                                 default=None),
               grad_max_abs_err=max((r["grad_max_abs_err"] for r in rows),
                                    default=None),
               flash_launches=rows[-1]["flash_launches"] if rows else None)
    phase("flash_wide_layer_repeats", **out)
    if failures:
        raise AssertionError(
            f"wide attention layer: {len(failures)} of {repeats} repeats "
            f"failed; first: {failures[0]['error']}")
    return out


def _diagnose_wide_layer(net, name, params, xv, mask, y_gpu, y_cpu, heads):
    """Where the wide layer's card output parted from the float64 CPU
    reference (``y_cpu``): each projection (card against the CPU's
    float32), the flash forward on the card's own q, k, v against its
    plain version on the CPU, the attention outputs card against CPU, the
    output projection of the card's attention output on both, whether a
    second card forward repeats the first one's bits, a float32 CPU
    forward against the reference and the card against it, and the
    matmul settings. Printed as a phase line before the check's failure
    is raised."""
    def stages(dev):
        p = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        x, m = xv.to(dev), mask.to(dev)
        w = {k.rsplit(".", 1)[1]: v for k, v in p.items()}
        B, T, S = x.shape

        def split(t):
            return t.reshape(B, T, heads, S // heads).transpose(1, 2)

        qkv = [split(x @ w[k]).contiguous() for k in ("wq", "wk", "wv")]
        with torch.no_grad():
            y = net.apply(p, {"x": Argument(x, m)})[name].value
        return p, m, qkv, y.cpu()

    p_cpu, m_cpu, qkv_cpu, y_cpu_again = stages("cpu")
    p_gpu, m_gpu, qkv_gpu, y_again = stages("cuda")
    wo = next(k for k in params if k.endswith(".wo"))
    merge = lambda o: o.transpose(1, 2).reshape(  # noqa: E731
        o.shape[0], o.shape[2], -1)
    with torch.no_grad():
        o_gpu = ATT.flash_attention(*qkv_gpu, m_gpu).cpu()
        o_plain = ATT.flash_attention(*(t.cpu() for t in qkv_gpu), m_cpu)
        o_cpu = ATT.flash_attention(*qkv_cpu, m_cpu)
        proj_gpu = (merge(o_gpu).cuda() @ p_gpu[wo]).cpu()
        proj_cpu = merge(o_gpu) @ p_cpu[wo]
    bad = (y_gpu - y_again).ne(0).nonzero()
    err = lambda a, b: (a - b).abs().max().item()  # noqa: E731
    phase("flash_wide_layer_diagnosis",
          projection_max_abs_err={
              k: (g.cpu() - c).abs().max().item()
              for k, g, c in zip(("q", "k", "v"), qkv_gpu, qkv_cpu)},
          flash_fwd_vs_plain_max_abs_err=err(o_gpu, o_plain),
          attention_card_vs_cpu_max_abs_err=err(o_gpu, o_cpu),
          out_projection_card_vs_cpu_max_abs_err=err(proj_gpu, proj_cpu),
          second_forward_bit_equal=bool(len(bad) == 0),
          second_forward_differs_at=bad[:16].tolist(),
          cpu_f32_forward_vs_reference_max_abs_err=err(y_cpu_again, y_cpu),
          y_card_vs_cpu_f32_max_abs_err=err(y_gpu, y_cpu_again),
          matmul=dict(precision=torch.get_float32_matmul_precision(),
                      cuda_tf32=torch.backends.cuda.matmul.allow_tf32,
                      cpu_threads=torch.get_num_threads()),
          host_cpu=_host_cpu())


def _baseline_flash_pieces(q, k, v, mask, o, lse, do):
    """Both flash wrappers' host paths in their baseline spelling
    (``_check``: ``cuda_device``, the shape and instance checks, a
    ``check_tensors`` per call (two in the backward); ``torch.empty`` of
    every output; a ``torch.cuda.device`` guard and ``current_stream()``;
    ``data_ptr()`` of every operand; the entry), piece by piece and whole:
    the "before" of the host split. Returns (forward, backward) pieces."""
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    dev = q.device
    scale = D ** -0.5
    fwd = build.bind("flash_attn", "flash_fwd", 6, 7, 1)
    bwd = build.bind("flash_attn", "flash_bwd", 11, 7, 1)
    delta = torch.empty((B * N, Tq), device=dev)
    outs = [torch.empty_like(t) for t in (q, k, v)]
    stream = torch.cuda.current_stream().cuda_stream
    f_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
              o.data_ptr(), lse.data_ptr(), B, N, Tq, Tk, D, 0, 0, scale)
    b_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
              o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              *(t.data_ptr() for t in outs), B, N, Tq, Tk, D, 0, 0, scale)

    def check(kernel, **more):
        d = build.cuda_device(kernel, q)
        if q.dim() != 4 or k.dim() != 4:
            raise ValueError(kernel)
        if D not in ATT.HEAD_DIMS:
            raise ValueError(kernel)
        if Tq < 1 or Tk < 1 or B * N > 65535:
            raise ValueError(kernel)
        build.check_tensors(kernel, d, q=(q, (B, N, Tq, D)),
                            k=(k, (B, N, Tk, D)), v=(v, (B, N, Tk, D)),
                            kv_mask=(mask, (B, Tk)),
                            **{n: (t, (B, N, Tq, D)) for n, t in more.items()})
        return d

    def f_checks():
        return check("flash_fwd")

    def b_checks():
        d = check("flash_bwd", o=o, do=do)
        build.check_tensors("flash_bwd", d, lse=(lse, (2, B * N, Tq)))
        return d

    def f_alloc():
        return (torch.empty_like(q),
                torch.empty((2, B * N, Tq), dtype=torch.float32, device=dev))

    def b_alloc():
        return (torch.empty((B * N, Tq), dtype=torch.float32, device=dev),
                *(torch.empty_like(t) for t in (q, k, v)))

    def guard_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    def whole(checks, alloc, fn, args):
        def run():
            d = checks()
            alloc()
            with torch.cuda.device(d):
                st = torch.cuda.current_stream().cuda_stream
                build.raise_on(fn(*args, st), "flash")
        return run

    pieces = []
    for checks, alloc, fn, args, ptrs in (
            (f_checks, f_alloc, fwd, f_args, (q, k, v, mask, o, lse)),
            (b_checks, b_alloc, bwd, b_args,
             (q, k, v, mask, o, do, lse, delta, *outs))):
        pieces.append(dict(
            checks=checks, alloc=alloc, guard_stream=guard_stream,
            data_ptr=lambda ptrs=ptrs: [t.data_ptr() for t in ptrs],
            ctypes_call=lambda fn=fn, args=args: fn(*args, stream),
            whole=whole(checks, alloc, fn, args)))
    return pieces


def _flash_pieces(q, k, v, mask, o, lse, do):
    """The same pieces of today's wrappers (``ATT.flash_fwd``,
    ``ATT.flash_bwd``), with the 16-byte alignment check they add."""
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    idx = q.get_device()
    scale = D ** -0.5
    fwd = build.bind("flash_attn", "flash_fwd", 6, 7, 1)
    bwd = build.bind("flash_attn", "flash_bwd", 11, 7, 1)
    delta = q.new_empty((B * N, Tq))
    outs = [torch.empty_like(t) for t in (q, k, v)]
    f_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
              o.data_ptr(), lse.data_ptr(), B, N, Tq, Tk, D, 0, 0, scale,
              torch._C._cuda_getCurrentRawStream(idx))
    b_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
              o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              *(t.data_ptr() for t in outs), B, N, Tq, Tk, D, 0, 0, scale,
              torch._C._cuda_getCurrentRawStream(idx))
    guard = lambda: (torch.cuda.current_device() == idx,
                     torch._C._cuda_getCurrentRawStream(idx))
    return [
        dict(checks=lambda: ATT._check("flash_fwd", q, k, v, mask),
             align=lambda: [build.aligned(t) for t in (q, k, v)],
             alloc=lambda: (torch.empty_like(q), q.new_empty((2, B * N, Tq))),
             guard_stream=guard,
             data_ptr=lambda: [t.data_ptr() for t in (q, k, v, mask, o,
                                                      lse)],
             ctypes_call=lambda: fwd(*f_args),
             whole=lambda: ATT.flash_fwd(q, k, v, mask, False)),
        dict(checks=lambda: ATT._check("flash_bwd", q, k, v, mask, o, lse,
                                       do),
             align=lambda: [build.aligned(t) for t in (q, k, v, o, do)],
             alloc=lambda: (q.new_empty((B * N, Tq)), torch.empty_like(q),
                            torch.empty_like(k), torch.empty_like(v)),
             guard_stream=guard,
             data_ptr=lambda: [t.data_ptr() for t in (q, k, v, mask, o, do,
                                                      lse, delta, *outs)],
             ctypes_call=lambda: bwd(*b_args),
             whole=lambda: ATT.flash_bwd(q, k, v, mask, o, lse, do, False))]


def check_flash_host_split():
    """The host split (``_split_us``: median of 5 interleaved rounds of 400
    calls) of both wrappers' launch paths at the attention seq2seq path's
    shape (FLASH_SHAPES[0]), the baseline spelling replayed beside
    today's, and of ``flash_attention``'s entries (no grad: the forward
    wrapper; training: ``FlashFunction``, its autograd share)."""
    B, N, Tq, Tk, D, causal, min_len, pad_row = FLASH_SHAPES[0]
    q, k, v, mask, do = _flash_inputs(B, N, Tq, Tk, D, 7, min_len, pad_row)
    o, lse = ATT.flash_fwd(q, k, v, mask, causal)
    base_f, base_b = _baseline_flash_pieces(q, k, v, mask, o, lse, do)
    now_f, now_b = _flash_pieces(q, k, v, mask, o, lse, do)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    got = _split_us(dict(
        fwd_baseline=(False, base_f), fwd_now=(False, now_f),
        bwd_baseline=(False, base_b), bwd_now=(False, now_b),
        infer=(False, dict(infer_entry=lambda: ATT.flash_attention(
            q, k, v, mask))),
        train=(True, dict(train_entry=lambda: ATT.flash_attention(
            *leaves, mask)))))
    row = dict(B=B, N=N, Tq=Tq, Tk=Tk, D=D,
               host_us_fwd_baseline=got["fwd_baseline"],
               host_us_fwd=got["fwd_now"],
               host_us_bwd_baseline=got["bwd_baseline"],
               host_us_bwd=got["bwd_now"],
               host_us_entry=dict(
                   infer_entry=got["infer"]["infer_entry"],
                   train_entry=got["train"]["train_entry"],
                   autograd=got["train"]["train_entry"]
                   - got["infer"]["infer_entry"]))
    phase("flash_host_split", **row)
    return row


def flash_kernels():
    """``--flash-kernels``: phase 7 alone (every FLASH_SHAPES,
    FLASH_WIDE_SHAPES and FLASH_SPLIT_SHAPES row with the SDPA yardstick,
    the wide-head layer
    check, the host split of both wrappers); rows in
    ``flash_kernels.json`` in ``OUT_DIR``."""
    build.build_all(["flash_attn"])
    out = dict(flash_shapes=check_flash_kernels(),
               flash_wide_layer=check_wide_attention_layers(
                   WIDE_LAYER_REPEATS),
               flash_host_split=check_flash_host_split())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "flash_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)


# ------------------------------------------------------------- 8. train
def _write_config(path, optimizer):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import (
                integer_value, integer_value_sequence)
            from paddle_tpu_torch.models.lstm_text import \\
                lstm_text_classifier
            from paddle_tpu_torch.optim import Adam
            cost, out, _ = lstm_text_classifier(**{MODEL!r})
            outputs = [out]
            {optimizer}
            feeding = DataFeeder(
                {{"words": integer_value_sequence({MODEL['vocab_size']}),
                  "label": integer_value({MODEL['classes']})}},
                pad_multiple={SEQLEN})

            def train_reader():
                # fixed batches: lengths 1-{SEQLEN}, ids from the seed, the
                # label says whether most ids lie in the table's lower half
                rng = np.random.default_rng({SEED})
                for _ in range({TRAIN_BATCHES}):
                    batch = []
                    for n in rng.integers(1, {SEQLEN + 1},
                                          size={TRAIN_BATCH}):
                        ids = rng.integers(0, {MODEL['vocab_size']},
                                           size=int(n))
                        low = (ids < {MODEL['vocab_size'] // 2}).mean()
                        batch.append((ids.tolist(), int(low > 0.5)))
                    yield batch
        """))


def _cli_inproc(args):
    """One CLI job (``python -m paddle_tpu_torch.trainer.cli``'s
    ``main``) in this process: no interpreter start-up, no second load of
    the kernels; the job resets the kernel counts its summary reports and
    the DSL's graph. Its standard output."""
    import contextlib
    import io

    from paddle_tpu_torch.trainer import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    if rc != 0:
        sys.stderr.write(buf.getvalue()[-4000:])
        raise AssertionError(f"trainer.cli {' '.join(args[:4])} returned "
                             f"{rc}")
    return buf.getvalue()


def _train_run(conf, passes, save_dir=None, batches=TRAIN_BATCHES,
               extra=()):
    """One ``--job train`` process: (per-pass costs, train_summary).
    ``extra``: further CLI arguments."""
    args = ["--config", conf, "--job", "train", "--num_passes", str(passes),
            "--seed", str(SEED), *extra]
    if save_dir:
        args += ["--save_dir", save_dir]
    out = _cli_inproc(args)
    costs = [float(ln.split("cost=")[1].split()[0])
             for ln in out.splitlines() if ln.startswith("Pass ")]
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    if len(costs) != passes or summary["steps"] != passes * batches:
        raise AssertionError(f"train run printed {costs}, {summary}")
    return costs, summary


def _grads_card_vs_cpu(build_model, save_dir, feed, optimizer):
    """One batch's loss and every parameter gradient from the newest
    checkpoint of ``save_dir``: the card (kernels) against the plain path
    on the CPU, per tensor ``max|g_card - g_cpu| <= 1e-3 * max|g_cpu| +
    1e-6``: both are float32 through every recurrent step, with every sum
    in another order. The same plain path in float64 on the CPU is the
    reference that shows how far each float32 result is from the exact
    one (``err64``)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = build_model()[0]
    params, _ = load_params(latest_checkpoint(save_dir))
    runs = {}
    for key, device, dtype in (("cuda", "cuda", torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
        trainer = SGD(cost, parameters=params, device=device,
                      update_equation=optimizer)
        trainer.params = {k: v.to(dtype) for k, v in trainer.params.items()}
        dev_feed = trainer._to_device(feed)
        for arg in dev_feed.values():  # dense frames in the run's type
            if arg.value.is_floating_point():
                arg.value = arg.value.to(dtype)
        t0 = time.perf_counter()
        _, loss, grads, _ = trainer.loss_and_grads(dev_feed)
        runs[key] = (float(loss), {k: v.cpu().double() for k, v in
                                   grads.items()},
                     time.perf_counter() - t0)
        del trainer
    loss_g, loss_c = runs["cuda"][0], runs["cpu"][0]
    if not np.isfinite(loss_g) or abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        raise AssertionError(f"loss on the card {loss_g}, on the CPU "
                             f"{loss_c}")
    errs = {}
    for name, gc in runs["cpu"][1].items():
        gg, g64 = runs["cuda"][1][name], runs["cpu64"][1][name]
        err = (gg - gc).abs().max().item()
        limit = 1e-3 * gc.abs().max().item() + 1e-6
        errs[name] = dict(err=err, max_abs=gc.abs().max().item(),
                          err64_cuda=(gg - g64).abs().max().item(),
                          err64_cpu=(gc - g64).abs().max().item())
        if not (err <= limit):
            raise AssertionError(f"gradient {name}: max abs err {err} > "
                                 f"{limit} ({errs[name]})")
    return dict(loss_cuda=loss_g, loss_cpu=loss_c,
                loss_cpu64=runs["cpu64"][0], grads=errs,
                seconds={k: v[2] for k, v in runs.items()})


def check_full_width_grads(save_dir):
    """The LSTM classifier's full-width gradients (16 rows, lengths 1-100)
    from the trained checkpoint, card against CPU."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    rng = np.random.default_rng(SEED + 1)
    batch = [(rng.integers(0, MODEL["vocab_size"], size=int(n)).tolist(),
              int(rng.integers(0, MODEL["classes"])))
             for n in rng.integers(1, SEQLEN + 1, size=GRAD_CHECK_ROWS)]
    feed = DataFeeder({"words": integer_value_sequence(MODEL["vocab_size"]),
                       "label": integer_value(MODEL["classes"])},
                      pad_multiple=SEQLEN, device="cpu")(batch)
    return dict(rows=GRAD_CHECK_ROWS, **_grads_card_vs_cpu(
        lambda: lstm_text_classifier(**MODEL), save_dir, feed,
        Adam(learning_rate=2e-3)))


def _check_opt_launches(where, counts, steps, kind="adam"):
    """One grouped optimizer launch a step: every path's list fits one
    table of the multi-tensor kernel."""
    if counts[kind]["launches"] != steps:
        raise AssertionError(f"{where}: {counts[kind]['launches']} {kind} "
                             f"launches in {steps} steps, one a step "
                             "expected")


def _check_lstm_chains(where, counts, chains):
    """The LSTM on a path's persistent route: one reverse-chain launch per
    layer, direction and step (``chains``), no per-step backward, and one
    device launch per forward call."""
    got = (counts["lstm_bwd_chain"]["launches"],
           counts["lstm_bwd_step"]["launches"])
    if got != (chains, 0):
        raise AssertionError(f"{where}: {got[0]} LSTM chains (expected "
                             f"{chains}), {got[1]} backward steps")
    for name in ("lstm_seq", "lstm_seq_train"):
        if counts[name]["step_launches"] != counts[name]["launches"]:
            raise AssertionError(f"{where}: {name} took the per-step route "
                                 f"({counts[name]})")


def _classifier_batch():
    """One CPU-fed batch of TRAIN_BATCH rows (lengths 1-SEQLEN) for the
    classifier's step trace."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    rng = np.random.default_rng(SEED + 2)
    batch = [(rng.integers(0, MODEL["vocab_size"], size=int(n)).tolist(),
              int(rng.integers(0, MODEL["classes"])))
             for n in rng.integers(1, SEQLEN + 1, size=TRAIN_BATCH)]
    return DataFeeder({"words": integer_value_sequence(MODEL["vocab_size"]),
                       "label": integer_value(MODEL["classes"])},
                      pad_multiple=SEQLEN, device="cpu")(batch)


def train(tmp):
    """--job train (Adam, 3 passes, --save_dir), one Momentum pass, the
    full-width gradient check, one traced step, --job merge. Returns
    (result, conf, model)."""
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, "train_conf.py")
    _write_config(conf, "optimizer = Adam(learning_rate=2e-3)")
    save_dir = os.path.join(tmp, "ckpt")
    costs, summary = _train_run(conf, TRAIN_PASSES, save_dir)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"pass costs {costs} do not fall")
    counts = summary["kernels"]
    if counts["lstm_seq_train"]["launches"] <= 0:
        raise AssertionError("--job train never launched lstm_seq_train")
    _check_opt_launches("--job train", counts, summary["steps"])
    _check_lstm_chains("--job train", counts,
                       MODEL["num_layers"] * summary["steps"])
    mom_conf = os.path.join(tmp, "momentum_conf.py")
    _write_config(mom_conf, "# no optimizer: the CLI's default Momentum")
    mom_costs, mom_summary = _train_run(mom_conf, 1)
    _check_opt_launches("the Momentum pass", mom_summary["kernels"],
                        mom_summary["steps"], "momentum")
    _check_lstm_chains("the Momentum pass", mom_summary["kernels"],
                       MODEL["num_layers"] * mom_summary["steps"])
    grads = check_full_width_grads(save_dir)
    trace = _step_trace(lambda: lstm_text_classifier(**MODEL), save_dir,
                        Adam(learning_rate=2e-3), _classifier_batch())
    model = os.path.join(tmp, "lstm_text_h1280.ptmodel")
    _cli_inproc(["--config", conf, "--job", "merge", "--save_dir", save_dir,
                 "--model_path", model])
    result = dict(pass_costs=costs, steps=summary["steps"],
                  median_step_ms=summary["median_step_ms"],
                  step_ms=summary["step_ms"], kernels=counts,
                  momentum_pass_costs=mom_costs,
                  momentum_median_step_ms=mom_summary["median_step_ms"],
                  momentum_kernels=mom_summary["kernels"], grad_check=grads,
                  step_trace=trace)
    phase("train", **result)
    return result, conf, model


# ----------------------------------------------------- 8. seq2seq train
_S2S_SAMPLES = """
def samples(rng, n):
    # source ids past 0 = <s> and 1 = </s>, lengths {lo}-{hi}; the target
    # is the source reversed, fed as <s> + target[:-1] and predicted whole
    out = []
    for length in rng.integers({lo}, {hi} + 1, size=n):
        src = rng.integers(2, {vocab}, size=int(length)).tolist()
        trg = src[::-1]
        out.append((src, [0] + trg[:-1], trg))
    return out
""".format(lo=S2S_MIN_LEN, hi=S2S_LEN, vocab=S2S["src_vocab"])


def _s2s_samples(rng, n):
    ns = {}
    exec(_S2S_SAMPLES, ns)
    return ns["samples"](rng, n)


def _s2s_feeding():
    from paddle_tpu_torch.data.types import integer_value_sequence
    return {"source_words": integer_value_sequence(S2S["src_vocab"]),
            "target_words": integer_value_sequence(S2S["trg_vocab"]),
            "target_next": integer_value_sequence(S2S["trg_vocab"])}


def _write_s2s_config(path, model):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import integer_value_sequence
            from paddle_tpu_torch.models.seq2seq import seq2seq_attention
            from paddle_tpu_torch.optim import Adam
            cost, probs, _ = seq2seq_attention(**{model!r})
            optimizer = Adam(learning_rate=5e-4)
            feeding = DataFeeder(
                {{"source_words": integer_value_sequence({S2S['src_vocab']}),
                  "target_words": integer_value_sequence({S2S['trg_vocab']}),
                  "target_next": integer_value_sequence({S2S['trg_vocab']})}},
                pad_multiple={S2S_LEN})
        """) + _S2S_SAMPLES + textwrap.dedent(f"""

            def train_reader():
                rng = np.random.default_rng({SEED})
                for _ in range({S2S_BATCHES}):
                    yield samples(rng, {S2S_BATCH})

            def test_reader():
                rng = np.random.default_rng({SEED + 2})
                for _ in range(2):
                    yield samples(rng, {S2S_BATCH})
        """))


def _s2s_step_split(save_dir, model):
    """Where one full-width seq2seq training step's time goes, on the card
    from the trained checkpoint, for one batch of S2S_BATCH rows (host
    clock, each part ending in a synchronise; median of 3 after one warm
    step): the encoder's forward alone (embedding, both GRU kernels, the
    projections), the whole forward (the recurrent group's Python loop on
    top), the backward and the Adam update; and, from one step under
    ``torch.profiler``, the device's busy time (every kernel's device
    time summed), its idle share and the five kernels that take most."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = seq2seq_attention(**model)[0]
    params, _ = load_params(latest_checkpoint(save_dir))
    tr = SGD(cost, parameters=params, device="cuda",
             update_equation=Adam(learning_rate=5e-4))
    encoder = Network(tr.topology.graph,
                      outputs=["encoded_proj", "decoder_boot"])
    feed = tr._to_device(DataFeeder(
        _s2s_feeding(), pad_multiple=S2S_LEN, device="cpu")(
        _s2s_samples(np.random.default_rng(SEED), S2S_BATCH)))

    def step(times=None, encoder_alone=True):
        t0 = time.perf_counter()
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in tr.params.items()}
        if encoder_alone:
            encoder.apply(leaves, feed, train=True)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = tr._total_cost(tr.network.apply(leaves, feed, train=True))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.params, tr.opt_state = tr.optimizer.update(
            grads, tr.opt_state, tr.params, tr.meta, batch_size=S2S_BATCH)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if times is not None:
            for k, v in (("encoder_fwd_ms", t1 - t0), ("fwd_ms", t2 - t1),
                         ("bwd_ms", t3 - t2), ("update_ms", t4 - t3)):
                times.setdefault(k, []).append(1e3 * v)

    step()
    times = {}
    for _ in range(3):
        step(times)
    split = {k: statistics.median(v) for k, v in times.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(encoder_alone=False)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op's own entry repeats the device
    # time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    split.update(
        profiled_step_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_kernels=[dict(name=e.key[:80], ms=1e-3 * e.self_device_time_total,
                          count=e.count) for e in top])
    return split


def _check_cell_route(where, counts, name):
    """Every GRU-cell call of a path ran on the cluster route: one device
    launch a call (its shapes, 50 x 512 and 32 or 4 x 512, are on it)."""
    if counts["step_launches"] != counts["launches"]:
        raise AssertionError(f"{where}: {name} made {counts['step_launches']}"
                             f" device launches in {counts['launches']} "
                             "calls, not one a call")


def train_seq2seq(tmp, model, title, train_kernels=(), test_kernels=()):
    """--job train of the full-width seq2seq ``model`` (Adam(5e-4), 3
    passes, --save_dir), the full-width gradient check card vs CPU, the
    step split, and --job test of the trained checkpoint on the card; the
    fresh processes' counts must show the GRU kernels, Adam and the named
    ``train_kernels`` / ``test_kernels`` launched."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, f"{title}_conf.py")
    _write_s2s_config(conf, model)
    save_dir = os.path.join(tmp, f"{title}_ckpt")
    costs, summary = _train_run(conf, S2S_PASSES, save_dir,
                                batches=S2S_BATCHES)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"{title} pass costs {costs} do not fall")
    counts = summary["kernels"]
    for name in ("gru_seq_train", "gru_bwd_chain", "gru_cell",
                 *train_kernels):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"{title} --job train never launched "
                                 f"{name}")
    _check_opt_launches(f"{title} --job train", counts, summary["steps"])
    if counts["gru_bwd_step"]["launches"] != 0:
        raise AssertionError(f"{title}: the per-step GRU backward ran on "
                             "the persistent route's shape")
    _check_cell_route(title, counts["gru_cell"], "gru_cell")
    feed = DataFeeder(_s2s_feeding(), pad_multiple=S2S_LEN, device="cpu")(
        _s2s_samples(np.random.default_rng(SEED + 1), S2S_GRAD_ROWS))
    grads = dict(rows=S2S_GRAD_ROWS, **_grads_card_vs_cpu(
        lambda: seq2seq_attention(**model), save_dir, feed,
        Adam(learning_rate=5e-4)))
    split = _s2s_step_split(save_dir, model)
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir])
    test_cost = float(out.split("Test: cost=")[1].split()[0])
    test_counts = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("test_summary "))[13:])[
        "kernels"]
    if not np.isfinite(test_cost):
        raise AssertionError(f"--job test cost {test_cost}")
    for name in ("gru_seq", "gru_cell_infer", *test_kernels):
        if test_counts[name]["launches"] <= 0:
            raise AssertionError(f"{title} --job test never launched {name}")
    _check_cell_route(title, test_counts["gru_cell_infer"], "gru_cell_infer")
    result = dict(pass_costs=costs, steps=summary["steps"],
                  median_step_ms=summary["median_step_ms"],
                  step_ms=summary["step_ms"], kernels=counts,
                  grad_check=grads, step_split=split, test_cost=test_cost,
                  test_kernels=test_counts)
    phase(title, **result)
    return result, save_dir


# ------------------------------------------------------------- 9. serve
def _batch_buckets(max_batch):
    """The serve CLI's menu: powers of two up to max_batch."""
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


def _http(port, method, path, body=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _launches(port, kernel="lstm_seq"):
    status, h = _http(port, "GET", "/healthz")
    if status != 200:
        raise AssertionError(f"/healthz answered {status}: {h}")
    return h["kernels"][kernel]


def _wait_ready(proc, timeout):
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode} "
                                     "before it was ready")
            continue
        if line.startswith("serving on http://"):
            return int(line.split()[2].rsplit(":", 1)[1])
    raise AssertionError(f"server not ready within {timeout}s")


def _serve_cmd(conf, model, length_buckets, max_batch, extra=()):
    return [sys.executable, "-m", "paddle_tpu_torch.trainer.cli",
            "--config", conf, "--job", "serve", "--init_model_path", model,
            "--max_batch", str(max_batch), "--serving_length_buckets",
            ",".join(map(str, length_buckets)), "--port", "0", *extra]


@contextlib.contextmanager
def _server(tmp, conf, model, length_buckets, max_batch=MAX_BATCH,
            extra=(), name="server"):
    """A ``--job serve`` process of the merged ``model`` (``extra``: more
    flags; its standard error in ``tmp/<name>.stderr``): yields (port,
    seconds until ready, [exit code]); on leaving, SIGTERM must drain it to
    exit 0, and the list then holds that code."""
    t_start = time.perf_counter()
    log_path = os.path.join(tmp, f"{name}.stderr")
    err_log = open(log_path, "w")
    proc = subprocess.Popen(
        _serve_cmd(conf, model, length_buckets, max_batch, extra),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=err_log, text=True)
    rc = []
    try:
        port = _wait_ready(proc, timeout=600)
        yield port, time.perf_counter() - t_start, rc
        proc.send_signal(signal.SIGTERM)
        rc.append(proc.wait(timeout=120))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err_log.close()
    if rc[0] != 0:
        with open(log_path) as f:
            sys.stderr.write(f.read()[-4000:])
        raise AssertionError(f"server exited {rc[0]} after SIGTERM")


def serve(tmp, conf, model):
    """Serve the merged PTM1 ``model`` with the config ``conf``."""
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.serving import ServingPredictor

    feeding = {"words": integer_value_sequence(MODEL["vocab_size"]),
               "label": integer_value(MODEL["classes"])}

    rng = np.random.default_rng(SEED)

    def sample(n):
        return [rng.integers(0, MODEL["vocab_size"], size=n).tolist(),
                int(rng.integers(0, MODEL["classes"]))]

    singles = [sample(n) for n in (1, 37, 100)]
    rows = [sample(int(n)) for n in rng.integers(1, 101, size=24)]

    with _server(tmp, conf, model, LENGTH_BUCKETS) as (port, ready_s, rc):
        before = _launches(port)
        answers, times_ms = [], []
        for s in singles + [singles[-1]]:
            t0 = time.perf_counter()
            status, body = _http(port, "POST", "/v1/score", {"sample": s})
            times_ms.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"/v1/score answered {status}: {body}")
            answers.append(body["outputs"]["output"])
        t0 = time.perf_counter()
        status, body = _http(port, "POST", "/v1/score", {"rows": rows})
        rows_ms = 1e3 * (time.perf_counter() - t0)
        if status != 200:
            raise AssertionError(f"/v1/score rows answered {status}: {body}")
        answers += [r["outputs"]["output"] for r in body["results"]]
        after = _launches(port)

    got = np.asarray(answers, dtype=np.float64)
    if got.shape != (len(singles) + 1 + len(rows), MODEL["classes"]):
        raise AssertionError(f"answers have shape {got.shape}")
    if not np.isfinite(got).all():
        raise AssertionError("non-finite answers")
    sum_err = float(np.abs(got.sum(axis=1) - 1.0).max())
    if sum_err > 1e-5:
        raise AssertionError(f"softmax rows sum to 1 +- {sum_err}")
    if answers[2] != answers[3]:
        raise AssertionError("two identical requests answered differently")
    ref = ServingPredictor.from_merged(
        model, feeding, batch_buckets=_batch_buckets(MAX_BATCH),
        length_buckets=LENGTH_BUCKETS, device="cpu")
    want = np.concatenate(
        [ref.predict_rows([tuple(s) for s in singles + [singles[-1]]])[0]
         ["output"][:len(singles) + 1],
         ref.predict_rows([tuple(r) for r in rows])[0]["output"][:len(rows)]])
    ref_err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, **TOL)
    launches = after["launches"] - before["launches"]
    steps = after["step_launches"] - before["step_launches"]
    if launches <= 0:
        raise AssertionError("the serving path never launched lstm_seq")
    if steps != launches:
        raise AssertionError(f"the served lstm_seq calls took the per-step "
                             f"route ({launches} calls, {steps} launches)")
    result = dict(ready_s=ready_s, single_ms=times_ms, rows=len(rows),
                  rows_ms=rows_ms, requests=len(singles) + 1 + len(rows),
                  launches=launches, step_launches=steps,
                  max_abs_err_vs_cpu=ref_err, softmax_sum_err=sum_err,
                  server_exit=rc[0])
    phase("serve", **result)
    return result


# ------------------------------------------- 10b. seq2seq generation
def _write_gen_config(path):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            from paddle_tpu_torch.data.types import integer_value_sequence
            from paddle_tpu_torch.models.seq2seq import seq2seq_attention
            gen, _ = seq2seq_attention(**{S2S!r}, beam_size={GEN_BEAM},
                                       max_length={GEN_MAX_LEN},
                                       generating=True)
            outputs = [gen]
            feeding = {{"source_words": integer_value_sequence(
                {S2S['src_vocab']})}}
        """))


def _assert_generation_names(graph, trained, where):
    """Every parameter a generating graph reads (its encoder's, its beam
    group's hoisted step parameters, the generated word's embedding) is
    in the trained checkpoint: no generation parameter is made up."""
    from paddle_tpu_torch.core.generation import generation_params
    from paddle_tpu_torch.core.network import Network
    names = set(Network(graph, outputs=["gen"]).param_specs) | set(
        generation_params(graph))
    missing = sorted(names - set(trained))
    if missing:
        raise AssertionError(f"{where}: generation parameters missing from "
                             f"the trained checkpoint: {missing}")
    return sorted(names)


def _s2s_training():
    """The training graph of ``seq2seq_attention`` at S2S: its cost."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    dsl.reset()
    return seq2seq_attention(**S2S)[0]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _rescore_cpu(build_training, params, src, beams):
    """Teacher-forced scores on the CPU of the token sequences ``beams``
    for the source ``src``: the training graph's decoder (the same
    parameters) fed <s> + tokens[:-1], summing log max(p(token), 1e-20)
    over each sequence (in float64), the sum the search accumulates."""
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.data.feeder import DataFeeder
    cost = build_training()
    net = Network(cost.graph, outputs=["decoder_group"])
    feed = DataFeeder(_s2s_feeding(), pad_multiple=max(map(len, beams)),
                      device="cpu")([(src, [0] + b[:-1], b) for b in beams])
    p = {k: torch.as_tensor(np.asarray(params[k])) for k in net.param_specs}
    with torch.no_grad():
        probs = net.apply(p, feed)["decoder_group"].value
    nxt = feed["target_next"]
    lp = torch.log(torch.clamp_min(probs.gather(
        -1, nxt.value.long()[..., None])[..., 0], 1e-20))
    return (lp.double() * nxt.mask.double()).sum(dim=1).tolist()


#: the largest relative gap between the CPU's float32 totals of the two
#: beams at which the card's and the CPU's searches first part that float32
#: rounding (sums in another order on the card) may decide
TIE_RTOL = 1e-6


def _row_beams(tokens, scores, lengths, b):
    """Row ``b`` of a search's (tokens, scores, lengths) as a list of
    {"tokens", "score"}, best first."""
    return [{"tokens": tokens[b, k, :lengths[b, k]].tolist(),
             "score": float(scores[b, k])} for k in range(tokens.shape[1])]


def _predictor_generate(pred, rows, **hooks):
    """``pred.generate_rows(rows)``'s search with ``hooks``: the same
    feed, encoder and engine call, returning (tokens, scores, lengths)."""
    feed = pred.feeder([tuple(r) for r in rows])
    with torch.inference_mode():
        outer = pred.encoder.apply(pred.params, feed, train=False)
        return pred.engine.generate(
            pred.params, outer, beam_size=pred.gen_beam_size,
            max_length=pred.gen_max_length,
            decode_chunk=pred.gen_decode_chunk, **hooks)


def _search_trace(generate, b):
    """Run ``generate(**hooks)`` with a ``candidate_adjust`` and a
    ``stop_beam_search`` hook that change nothing and record, for row
    ``b``, each step's inputs to the candidate totals (the parents'
    prefixes, totals and finished flags, the log-probabilities) and the
    beams it kept (prefixes and totals). Returns (row b's beams, the
    steps)."""
    steps = []

    def adjust(logp, state):
        K = state["scores"].shape[1]
        steps.append(dict(parents=state["tokens"][b].cpu(),
                          scores=state["scores"][b].cpu(),
                          finished=state["finished"][b].cpu(),
                          logp=logp[b * K:(b + 1) * K].cpu()))
        return logp

    def stop(state, t):
        steps[-1].update(kept=state["tokens"][b, :, :t + 1].cpu(),
                         totals=state["scores"][b].cpu())
        return False

    out = [x.cpu() for x in generate(candidate_adjust=adjust,
                                     stop_beam_search=stop)]
    return _row_beams(*out, b), steps


def _candidate_total(step, t, prefix, eos):
    """A search's own float32 total at step ``t`` of the candidate
    ``prefix`` (its parent's total plus the token's log-probability, or
    the zero-cost EOS of a finished parent), from ``_search_trace``'s
    record of that step."""
    from paddle_tpu_torch.core.generation import NEG
    parents = [tuple(p[:t].tolist()) for p in step["parents"]]
    k, tok = parents.index(tuple(prefix[:-1])), prefix[-1]
    if bool(step["finished"][k]):
        return float(step["scores"][k] + (0.0 if tok == eos else NEG))
    return float(step["scores"][k] + step["logp"][k, tok])


def _parting(card, cpu, eos):
    """Where two traces of one search (``_search_trace``) first keep
    different beams, and how near a tie it was: the step, the beams only
    one of them kept, and the relative gap between the CPU's totals of
    the CPU's and the card's choices there (and the card's, of the
    same). Two searches that keep the same beams at every step and end
    in another order part at their final ranking."""
    for t, (a, c) in enumerate(zip(card, cpu)):
        kept_a = [tuple(p.tolist()) for p in a["kept"]]
        kept_c = [tuple(p.tolist()) for p in c["kept"]]
        if set(kept_a) != set(kept_c):
            only_a = sorted(set(kept_a) - set(kept_c))
            only_c = sorted(set(kept_c) - set(kept_a))
            break
    else:
        t = len(card) - 1
        moved = [k for k, (x, y) in enumerate(zip(kept_a, kept_c)) if x != y]
        only_a = [kept_a[k] for k in moved]
        only_c = [kept_c[k] for k in moved]

    def gap(trace, chose, other):
        mine = [_candidate_total(trace[t], t, p, eos) for p in chose]
        theirs = [_candidate_total(trace[t], t, p, eos) for p in other]
        return ((max(mine + theirs) - min(mine + theirs))
                / max(abs(x) for x in mine + theirs)), mine, theirs

    cpu_gap, cpu_own, cpu_of_card = gap(cpu, only_c, only_a)
    card_gap, card_own, card_of_cpu = gap(card, only_a, only_c)
    return dict(step=t, card_only=[list(p) for p in only_a],
                cpu_only=[list(p) for p in only_c],
                cpu_totals=cpu_own, cpu_totals_of_card_beams=cpu_of_card,
                card_totals=card_own, card_totals_of_cpu_beams=card_of_cpu,
                cpu_rel_gap=cpu_gap, card_rel_gap=card_gap)


def _compare_beams(got, want, rescore, trace, where):
    """The card's beams ``got`` against the CPU plain path's ``want``
    (lists of {"tokens", "score"}): best first, scores within 1e-4
    relative rank by rank, and the tokens identical, unless the two
    searches parted at a near-tie that float32 rounding decides. Then
    ``trace()`` (``_search_trace`` of the same search on the card and on
    the CPU, which must give ``got`` and ``want`` again) finds the first
    step at which they part, where the CPU's own totals of the beams that
    only one of them kept must lie within ``TIE_RTOL`` of each other;
    and ``rescore`` (the CPU's teacher-forced scores of the card's own
    beams) must give the card's scores within 1e-5 relative: the card's
    beams score what it says. Returns (worst relative score error
    against the CPU's beams, the parting or None)."""
    scores = [g["score"] for g in got]
    if len(got) != len(want) or scores != sorted(scores, reverse=True):
        raise AssertionError(f"{where}: beams {scores} not {len(want)} "
                             "best first")
    worst = max(_rel(g["score"], w["score"]) for g, w in zip(got, want))
    if not worst <= 1e-4:
        raise AssertionError(f"{where}: scores {scores} vs "
                             f"{[w['score'] for w in want]}")
    tokens = [g["tokens"] for g in got]
    if tokens == [w["tokens"] for w in want]:
        return worst, None
    (card_beams, card), (cpu_beams, cpu) = trace()
    if ([g["tokens"] for g in card_beams] != tokens
            or [w["tokens"] for w in cpu_beams]
            != [w["tokens"] for w in want]):
        raise AssertionError(f"{where}: the traced searches do not give "
                             "the beams they trace")
    part = _parting(card, cpu, GEN_EOS)
    if not part["cpu_rel_gap"] <= TIE_RTOL:
        raise AssertionError(
            f"{where}: the searches part at step {part['step']} where the "
            f"CPU's totals differ by {part['cpu_rel_gap']:.3g} relative, "
            f"more than float32 rounding decides: {part}")
    cpu_scores = rescore(tokens)
    if not all(_rel(g, c) <= 1e-5 for g, c in zip(scores, cpu_scores)):
        raise AssertionError(
            f"{where}: tokens differ from the CPU's ({tokens} vs "
            f"{[w['tokens'] for w in want]}) and the card's scores {scores} "
            f"are not their CPU rescoring {cpu_scores}")
    return worst, part


def _check_partings(partings, answers, where):
    """At most one answer in eight (and one at least) may part from the
    CPU's at a float32 near-tie."""
    if len(partings) > max(1, answers // 8):
        raise AssertionError(f"{where}: {len(partings)} of {answers} "
                             f"answers part from the CPU's: {partings}")


def serve_generation(tmp, save_dir):
    """Path A: ``seq2seq_attention(generating=True)`` at 30000/512/512,
    beam 4, outputs of up to 50 words. ``--job merge`` of the generating
    config from phase 10's save dir (every generating parameter must be in
    the checkpoint), ``--job serve`` of it (max_batch 8, length buckets
    16,50): three single sources (lengths 1, 23, 50), a repeat and one
    ``rows`` call of 8 to ``POST /v1/generate``; each answer carries 4
    beams, best first, as the port's CPU plain path on the same file
    gives them; a repeat answers the
    same; an off-menu beam size gets the typed 400 with the menu;
    /healthz counts gru_cell_infer launches growing; SIGTERM drains to
    exit 0. The answers are held against the CPU's by
    ``_compare_beams``."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data.types import integer_value_sequence
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    from paddle_tpu_torch.serving import ServingPredictor
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    conf = os.path.join(tmp, "s2s_gen_conf.py")
    _write_gen_config(conf)
    dsl.reset()
    seq2seq_attention(**S2S, beam_size=GEN_BEAM, max_length=GEN_MAX_LEN,
                      generating=True)
    names = _assert_generation_names(
        dsl.current_graph(), load_params(latest_checkpoint(save_dir))[0],
        "seq2seq_attention(generating=True)")
    model = os.path.join(tmp, "s2s_gen.ptmodel")
    t0 = time.perf_counter()
    _cli_inproc(["--config", conf, "--job", "merge", "--save_dir", save_dir,
                 "--model_path", model])
    merge_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 4)

    def source(n):
        return [rng.integers(2, S2S["src_vocab"], size=int(n)).tolist()]

    singles = [source(n) for n in GEN_SERVE_LENGTHS]
    rows = [source(n) for n in rng.integers(1, S2S_LEN + 1,
                                            size=GEN_MAX_BATCH)]
    menu = {"beam_size": [GEN_BEAM], "max_length": [GEN_MAX_LEN]}
    with _server(tmp, conf, model, GEN_LENGTH_BUCKETS, GEN_MAX_BATCH) as (
            port, ready_s, rc):
        before = _launches(port, "gru_cell_infer")
        answers, times_ms = [], []
        for s in singles + [singles[1]]:
            t0 = time.perf_counter()
            status, body = _http(port, "POST", "/v1/generate", {"sample": s})
            times_ms.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"/v1/generate answered {status}: "
                                     f"{body}")
            answers.append(body["sequences"])
        t0 = time.perf_counter()
        status, body = _http(port, "POST", "/v1/generate", {"rows": rows})
        rows_ms = 1e3 * (time.perf_counter() - t0)
        if status != 200:
            raise AssertionError(f"/v1/generate rows answered {status}: "
                                 f"{body}")
        answers += [r["sequences"] for r in body["results"]]
        status, bad = _http(port, "POST", "/v1/generate",
                            {"sample": singles[0], "beam_size": GEN_BEAM + 1})
        if status != 400 or bad["error"].get("allowed") != menu:
            raise AssertionError(f"off-menu beam_size answered {status}: "
                                 f"{bad}")
        after = _launches(port, "gru_cell_infer")
    if answers[1] != answers[3]:
        raise AssertionError("two identical requests answered differently")
    ref = ServingPredictor.from_merged(
        model, {"source_words": integer_value_sequence(S2S["src_vocab"])},
        batch_buckets=_batch_buckets(GEN_MAX_BATCH),
        length_buckets=GEN_LENGTH_BUCKETS, device="cpu")
    from paddle_tpu_torch.trainer.merge_model import load_merged_ex
    merged = load_merged_ex(model)[1]
    card = []  # the served search again, in this process, to trace it

    def trace(i, s, got):
        """The served search of answer ``i`` traced on the card (its
        batch: the source alone, or the ``rows`` call, which the batcher
        may have run whole or in parts; the first that gives the served
        beams) and the CPU reference's."""
        if not card:
            card.append(ServingPredictor.from_merged(
                model, ref.feeding, batch_buckets=ref.batch_buckets,
                length_buckets=ref.length_buckets, device="cuda"))
        tried = [([s], 0)]
        if i > len(singles):
            tried.insert(0, (rows, i - len(singles) - 1))
        for batch, b in tried:
            traced = _search_trace(lambda **h: _predictor_generate(
                card[0], batch, **h), b)
            if [x["tokens"] for x in traced[0]] == [
                    x["tokens"] for x in got]:
                break
        return traced, _search_trace(lambda **h: _predictor_generate(
            ref, [s], **h), 0)

    worst, partings, t_cpu = 0.0, [], time.perf_counter()
    for i, (s, got) in enumerate(zip(singles + [singles[1]] + rows,
                                     answers)):
        (tk, sc, ln), _ = ref.generate_rows([tuple(s)])
        err, part = _compare_beams(
            got, _row_beams(tk, sc, ln, 0),
            lambda beams, src=s[0]: _rescore_cpu(
                _s2s_training, merged, src, beams),
            lambda i=i, s=s, got=got: trace(i, s, got), f"answer {i}")
        worst = max(worst, err)
        if part is not None:
            partings.append(dict(answer=i, **part))
    _check_partings(partings, len(answers), "/v1/generate")
    launches = after["launches"] - before["launches"]
    if launches <= 0:
        raise AssertionError("the generate path never launched "
                             "gru_cell_infer")
    _check_cell_route("/v1/generate", {
        k: after[k] - before[k] for k in ("launches", "step_launches")},
        "gru_cell_infer")
    result = dict(merge_s=merge_s, ready_s=ready_s,
                  single_lengths=list(GEN_SERVE_LENGTHS), single_ms=times_ms,
                  rows=len(rows), rows_ms=rows_ms, requests=len(answers),
                  answer_lengths=[[len(b["tokens"]) for b in a]
                                  for a in answers],
                  launches=launches,
                  step_launches=after["step_launches"]
                  - before["step_launches"],
                  max_rel_score_err_vs_cpu=worst, tie_flips=len(partings),
                  partings=partings,
                  cpu_reference_s=time.perf_counter() - t_cpu,
                  generation_params=len(names), server_exit=rc[0])
    phase("seq2seq_generate_serve", **result)
    return result


# ------------------------------------------ 11b. LSTM-step decoder path
# the lstmemory_group form of the seqToseq demo's decoder (width 30000 /
# 512 / 512): lstm_step over fc([word, h]) with its peepholes, the cell
# state carried by a memory linked to get_output; booted from the average
# source embedding. Training runs its step in a recurrent_group over the
# target embedding, generation the same step in a beam search.
_LSTM_DECODER = """
def lstm_decoder(dsl, generating=False):
    src = dsl.data(name="source_words", size={V}, is_sequence=True)
    semb = dsl.embedding(input=src, size={D}, name="src_emb")
    boot = dsl.fc(input=dsl.pooling(input=semb, pooling_type="avg",
                                    name="src_avg"),
                  size={D}, act="tanh", name="boot")

    def step(word):
        h = dsl.memory(name="h", size={D}, boot_layer=boot)
        c = dsl.memory(name="cst", size={D})
        gates = dsl.fc(input=[word, h], size={G}, act="linear",
                       name="gates")
        out = dsl.lstm_step_layer(gates, c, size={D}, name="h")
        dsl.get_output_layer(out, arg_name="state", size={D}, name="cst")
        return dsl.fc(input=out, size={V}, act="softmax", name="prob")

    if generating:
        return dsl.beam_search(
            step, [dsl.GeneratedInput(size={V}, embedding_name="_trg_emb.w0",
                                      embedding_size={D})],
            bos_id=0, eos_id={EOS}, beam_size={K}, max_length={L}, name="gen")
    trg = dsl.data(name="target_words", size={V}, is_sequence=True)
    trg_next = dsl.data(name="target_next", size={V}, is_sequence=True)
    temb = dsl.embedding(input=trg, size={D}, name="trg_emb")
    probs = dsl.recurrent_group(step, [temb], name="decoder_group")
    return dsl.classification_cost(input=probs, label=trg_next,
                                   name="decoder_cost")
""".format(V=S2S["trg_vocab"], D=S2S["hidden"], G=4 * S2S["hidden"],
           K=GEN_BEAM, L=GEN_MAX_LEN, EOS=GEN_EOS)


def _lstm_decoder(generating=False):
    from paddle_tpu_torch.config import dsl
    ns = {}
    exec(_LSTM_DECODER, ns)
    dsl.reset()
    return ns["lstm_decoder"](dsl, generating)


def _write_lstm_decoder_config(path):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import integer_value_sequence
            from paddle_tpu_torch.optim import Adam
        """) + _LSTM_DECODER + _S2S_SAMPLES + textwrap.dedent(f"""

            cost = lstm_decoder(dsl)
            optimizer = Adam(learning_rate=5e-4)
            feeding = DataFeeder(
                {{"source_words": integer_value_sequence({S2S['src_vocab']}),
                  "target_words": integer_value_sequence({S2S['trg_vocab']}),
                  "target_next": integer_value_sequence({S2S['trg_vocab']})}},
                pad_multiple={S2S_LEN})

            def train_reader():
                rng = np.random.default_rng({SEED})
                for _ in range({S2S_BATCHES}):
                    yield samples(rng, {S2S_BATCH})
        """))


def _decode_lstm_decoder(save_dir):
    """Beam search (K = 4, up to 50 words) of 8 sources with the
    LSTM-step decoder from the trained checkpoint, on the card (the counts
    set to 0 just before, read just after) and on the CPU, held together
    by ``_compare_beams``; lstm_cell_infer launched; the full scan
    identical to the chunked decode."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core.generation import SequenceGenerator
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import integer_value_sequence
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    from paddle_tpu_torch.config import dsl
    _lstm_decoder(generating=True)
    graph = dsl.current_graph()
    trained, _ = load_params(latest_checkpoint(save_dir))
    names = _assert_generation_names(graph, trained, "lstm_step decoder")
    sources = [(s,) for s, _, _ in _s2s_samples(
        np.random.default_rng(SEED + 5), GEN_SOURCES)]
    gen = SequenceGenerator(graph, "gen")
    encoder = Network(graph, outputs=gen.static_input_layers())
    runs = {}
    for dev in ("cuda", "cpu"):
        params = {k: torch.as_tensor(np.asarray(trained[k])).to(dev)
                  for k in names}
        feed = DataFeeder({"source_words": integer_value_sequence(
            S2S["src_vocab"])}, pad_multiple=S2S_LEN, device=dev)(sources)
        with torch.no_grad():
            outer = encoder.apply(params, feed)
        if dev == "cuda":
            torch.cuda.synchronize()
            ops.reset_kernel_counts()
        t0 = time.perf_counter()
        out = [t.cpu() for t in gen.generate(
            params, outer, beam_size=GEN_BEAM, max_length=GEN_MAX_LEN)]
        runs[dev] = dict(out=out, ms=1e3 * (time.perf_counter() - t0),
                         info=dict(gen.last_info), params=params,
                         outer=outer)
        if dev == "cuda":
            runs[dev]["counts"] = ops.kernel_counts()
            full = [t.cpu() for t in gen.generate(
                params, outer, beam_size=GEN_BEAM, max_length=GEN_MAX_LEN,
                full_scan=True)]
            if not all(torch.equal(a, b) for a, b in zip(out, full)):
                raise AssertionError("lstm_step decoder: the full scan "
                                     "differs from the chunked decode")
    def search(dev):
        r = runs[dev]
        return lambda **hooks: gen.generate(
            r["params"], r["outer"], beam_size=GEN_BEAM,
            max_length=GEN_MAX_LEN, **hooks)

    def trace(b):
        return (_search_trace(search("cuda"), b),
                _search_trace(search("cpu"), b))

    worst, partings = 0.0, []
    got, want = runs["cuda"]["out"], runs["cpu"]["out"]
    for b in range(GEN_SOURCES):
        err, part = _compare_beams(
            _row_beams(*got, b), _row_beams(*want, b),
            lambda toks, src=sources[b][0]: _rescore_cpu(
                _lstm_decoder, trained, src, toks),
            lambda b=b: trace(b), f"source {b}")
        worst = max(worst, err)
        if part is not None:
            partings.append(dict(source=b, **part))
    _check_partings(partings, GEN_SOURCES, "lstm_step decoder")
    counts = runs["cuda"]["counts"]
    if counts["lstm_cell_infer"]["launches"] <= 0:
        raise AssertionError("the decode never launched lstm_cell_infer")
    return dict(sources=GEN_SOURCES, beam=GEN_BEAM, max_length=GEN_MAX_LEN,
                cuda_ms=runs["cuda"]["ms"], cpu_ms=runs["cpu"]["ms"],
                info=runs["cuda"]["info"],
                lengths=got[2].tolist(),
                launches=counts["lstm_cell_infer"]["launches"],
                max_rel_score_err_vs_cpu=worst, tie_flips=len(partings),
                partings=partings, full_scan_identical=True, generation_params=len(names))


def lstm_decoder_path(tmp):
    """Path B: the LSTM-step decoder trained by ``--job train``
    (Adam(5e-4), 3 passes over 4 fixed batches of 50: the cost must fall,
    and the counts show lstm_cell and Adam launched), its full-width
    gradients (8 rows) card against CPU, then its beam search on the card
    against the CPU (``_decode_lstm_decoder``)."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, "lstm_decoder_conf.py")
    _write_lstm_decoder_config(conf)
    save_dir = os.path.join(tmp, "lstm_decoder_ckpt")
    costs, summary = _train_run(conf, S2S_PASSES, save_dir,
                                batches=S2S_BATCHES)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"lstm_step decoder pass costs {costs} do not "
                             "fall")
    counts = summary["kernels"]
    if counts["lstm_cell"]["launches"] <= 0:
        raise AssertionError("lstm_step decoder --job train never "
                             "launched lstm_cell")
    _check_opt_launches("lstm_step decoder --job train", counts,
                        summary["steps"])
    feed = DataFeeder(_s2s_feeding(), pad_multiple=S2S_LEN, device="cpu")(
        _s2s_samples(np.random.default_rng(SEED + 1), S2S_GRAD_ROWS))
    grads = dict(rows=S2S_GRAD_ROWS, **_grads_card_vs_cpu(
        lambda: (_lstm_decoder(),), save_dir, feed,
        Adam(learning_rate=5e-4)))
    decode = _decode_lstm_decoder(save_dir)
    result = dict(pass_costs=costs, steps=summary["steps"],
                  median_step_ms=summary["median_step_ms"],
                  step_ms=summary["step_ms"], kernels=counts,
                  grad_check=grads, decode=decode)
    phase("lstm_decoder", **result)
    return result


# ------------------------------------------------------------ 10. tagger
_TAG_SAMPLES = """
def samples(rng, lengths):
    # word ids from the seed; a word's chunk type is its id mod 12 (11 is
    # outside a chunk); IOB labels: 2 * type for the word that opens a
    # chunk, 2 * type + 1 for one that continues the previous word's type,
    # 22 = O, so each label depends on the word and the one before it
    out = []
    for length in lengths:
        words = rng.integers(0, {vocab}, size=int(length))
        tags, prev = [], -1
        for kind in (words % 12).tolist():
            tags.append(22 if kind == 11 else 2 * kind + (kind == prev))
            prev = kind
        out.append((words.tolist(), tags))
    return out


def batch(rng):
    return samples(rng, rng.integers({lo}, {hi} + 1, size={n}))
"""


def _tag_samples_src():
    return _TAG_SAMPLES.format(vocab=TAGGER["vocab_size"], lo=TAG_MIN_LEN,
                               hi=TAG_MAX_LEN, n=TAG_BATCH)


def _tag_samples():
    ns = {}
    exec(_tag_samples_src(), ns)
    return ns["samples"], ns["batch"]


def _tag_feeding():
    from paddle_tpu_torch.data.types import integer_value_sequence
    return {"word": integer_value_sequence(TAGGER["vocab_size"]),
            "label": integer_value_sequence(TAGGER["num_labels"])}


def _write_tagger_configs(tmp):
    """The training config (the tagger, the reference demo's labelled
    crf_decoding_layer on the shared transitions with its ``sum`` error
    and ``chunk`` F1 evaluators, outputs = the decode) and the serving one
    (the same model, fed the word slot alone)."""
    C = TAGGER["num_labels"]
    conf = os.path.join(tmp, "tagger_conf.py")
    with open(conf, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.config.model_config import ParamAttr
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import integer_value_sequence
            from paddle_tpu_torch.models.tagging import bilstm_crf_tagger
            from paddle_tpu_torch.optim import Adam
            cost, decoded, _ = bilstm_crf_tagger(**{TAGGER!r})
            label = dsl.LayerOutput("label", {C})
            checked = dsl.crf_decoding_layer(
                input=dsl.LayerOutput("emission", {C}), size={C},
                label=label, param_attr=ParamAttr(name="crf_transitions"),
                name="crf_check")
            dsl.evaluator("sum", checked, name="error")
            dsl.evaluator("chunk", checked, label=label, name="chunk_f1",
                          chunk_scheme="IOB", num_chunk_types={(C - 1) // 2})
            outputs = [decoded]
            optimizer = Adam(learning_rate=5e-3)
            feeding = DataFeeder(
                {{"word": integer_value_sequence({TAGGER['vocab_size']}),
                  "label": integer_value_sequence({C})}},
                pad_multiple={TAG_LEN})
        """) + _tag_samples_src() + textwrap.dedent(f"""

            def train_reader():
                rng = np.random.default_rng({SEED})
                for _ in range({TAG_BATCHES}):
                    yield batch(rng)

            def test_reader():
                rng = np.random.default_rng({SEED + 2})
                for _ in range({TAG_TEST_BATCHES}):
                    yield batch(rng)
        """))
    serve_conf = os.path.join(tmp, "tagger_serve_conf.py")
    with open(serve_conf, "w") as f:
        f.write(textwrap.dedent(f"""
            from paddle_tpu_torch.data.types import integer_value_sequence
            from paddle_tpu_torch.models.tagging import bilstm_crf_tagger
            cost, decoded, _ = bilstm_crf_tagger(**{TAGGER!r})
            outputs = [decoded]
            feeding = {{"word": integer_value_sequence(
                {TAGGER['vocab_size']})}}
        """))
    return conf, serve_conf


def train_tagger(tmp):
    """--job train of the tagger at CoNLL-2000 width (Adam(5e-3), 3 passes
    over 4 fixed batches, --save_dir; one CRF forward and one backward
    launch a step), the full-width gradient check card vs CPU (8 rows),
    --job test of the checkpoint on 2 more batches (one forward launch
    each), and --job merge with outputs = the decode."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.models.tagging import bilstm_crf_tagger
    from paddle_tpu_torch.optim import Adam
    conf, serve_conf = _write_tagger_configs(tmp)
    save_dir = os.path.join(tmp, "tagger_ckpt")
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       str(TAG_PASSES), "--seed", str(SEED), "--save_dir",
                       save_dir])
    passes = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    costs = [float(ln.split("cost=")[1].split()[0]) for ln in passes]
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    if len(costs) != TAG_PASSES or summary["steps"] != TAG_PASSES * \
            TAG_BATCHES:
        raise AssertionError(f"tagger train printed {passes}, {summary}")
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"tagger pass costs {costs} do not fall")
    counts = summary["kernels"]
    for name in ("crf_alpha_fwd", "crf_bwd", "crf_viterbi",
                 "lstm_seq_train"):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"tagger --job train never launched {name}")
    for name in ("crf_alpha_fwd", "crf_bwd"):  # one call each a step
        if counts[name]["launches"] != summary["steps"]:
            raise AssertionError(f"tagger --job train: {name} launched "
                                 f"{counts[name]['launches']} times in "
                                 f"{summary['steps']} steps")
    _check_opt_launches("tagger --job train", counts, summary["steps"])
    _check_lstm_chains("tagger --job train", counts, 2 * summary["steps"])
    samples, batch = _tag_samples()
    rng = np.random.default_rng(SEED + 1)
    feed = DataFeeder(_tag_feeding(), pad_multiple=TAG_LEN, device="cpu")(
        samples(rng, rng.integers(TAG_MIN_LEN, TAG_MAX_LEN + 1,
                                  size=TAG_GRAD_ROWS)))
    grads = dict(rows=TAG_GRAD_ROWS, **_grads_card_vs_cpu(
        lambda: bilstm_crf_tagger(**TAGGER), save_dir, feed,
        Adam(learning_rate=5e-3)))
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir])
    line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    test = {k: float(v) for k, v in (kv.split("=") for kv in
                                     line[len("Test: "):].split())}
    test_counts = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("test_summary "))[13:])[
        "kernels"]
    if set(test) != {"cost", "error", "chunk_f1"} or not all(
            np.isfinite(list(test.values()))):
        raise AssertionError(f"tagger --job test printed {line}")
    for name in ("crf_alpha_fwd", "crf_viterbi", "lstm_seq"):
        if test_counts[name]["launches"] <= 0:
            raise AssertionError(f"tagger --job test never launched {name}")
    if test_counts["crf_alpha_fwd"]["launches"] != TAG_TEST_BATCHES:
        raise AssertionError(f"tagger --job test: crf_alpha_fwd launched "
                             f"{test_counts['crf_alpha_fwd']['launches']} "
                             f"times in {TAG_TEST_BATCHES} batches")
    _check_lstm_chains("tagger --job test", test_counts, 0)
    model = os.path.join(tmp, "tagger.ptmodel")
    _cli_inproc(["--config", conf, "--job", "merge", "--save_dir", save_dir,
                 "--model_path", model])
    result = dict(pass_lines=passes, pass_costs=costs,
                  steps=summary["steps"],
                  median_step_ms=summary["median_step_ms"],
                  step_ms=summary["step_ms"], kernels=counts,
                  grad_check=grads, test=test, test_kernels=test_counts)
    phase("tagger_train", **result)
    return result, serve_conf, model


def serve_tagger(tmp, serve_conf, model):
    """--job serve of the merged tagger's Viterbi decode: 3 single
    sentences (lengths 1, 23, 78) and one call of 16 rows; the ids over
    the padded batch must equal the CPU plain path's on the same PTM1
    file, and /healthz must count crf_viterbi launches."""
    from paddle_tpu_torch.serving import ServingPredictor
    samples, _ = _tag_samples()
    rng = np.random.default_rng(SEED + 3)
    singles = [[w] for w, _ in samples(rng, TAG_SERVE_LENGTHS)]
    rows = [[w] for w, _ in samples(
        rng, rng.integers(1, TAG_MAX_LEN + 1, size=16))]
    with _server(tmp, serve_conf, model, TAG_LENGTH_BUCKETS) as (
            port, ready_s, rc):
        before = {k: _launches(port, k) for k in ("crf_viterbi", "lstm_seq")}
        answers, times_ms = [], []
        for s in singles:
            t0 = time.perf_counter()
            status, body = _http(port, "POST", "/v1/score", {"sample": s})
            times_ms.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"/v1/score answered {status}: {body}")
            answers.append(body["outputs"]["crf_decode"])
        t0 = time.perf_counter()
        status, body = _http(port, "POST", "/v1/score", {"rows": rows})
        rows_ms = 1e3 * (time.perf_counter() - t0)
        if status != 200:
            raise AssertionError(f"/v1/score rows answered {status}: {body}")
        answers += [r["outputs"]["crf_decode"] for r in body["results"]]
        after = {k: _launches(port, k) for k in ("crf_viterbi", "lstm_seq")}
    ref = ServingPredictor.from_merged(
        model, {"word": _tag_feeding()["word"]},
        batch_buckets=_batch_buckets(MAX_BATCH),
        length_buckets=TAG_LENGTH_BUCKETS, device="cpu")
    want = [ref.predict_rows([s])[0]["crf_decode"][0].tolist()
            for s in singles]
    want += ref.predict_rows(rows)[0]["crf_decode"][:len(rows)].tolist()
    wrong = [i for i, (g, w) in enumerate(zip(answers, want)) if g != w]
    if len(answers) != len(want) or wrong:
        raise AssertionError(f"served decodes differ from the CPU plain "
                             f"path's in answers {wrong}")
    lengths = [len(s[0]) for s in singles + rows]
    launches = {k: after[k]["launches"] - before[k]["launches"]
                for k in after}
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the serving path never launched {k}")
    steps = after["lstm_seq"]["step_launches"] - \
        before["lstm_seq"]["step_launches"]
    if steps != launches["lstm_seq"]:
        raise AssertionError(f"the served lstm_seq calls took the per-step "
                             f"route ({launches['lstm_seq']} calls, {steps} "
                             "launches)")
    result = dict(ready_s=ready_s, single_lengths=lengths[:3],
                  single_ms=times_ms, rows=len(rows), rows_ms=rows_ms,
                  requests=len(answers), launches=launches["crf_viterbi"],
                  lstm_seq_launches=launches["lstm_seq"],
                  answer_steps=[len(a) for a in answers],
                  equal_to_cpu=True, server_exit=rc[0])
    phase("tagger_serve", **result)
    return result


# ------------------------------------------- 11c. CTC acoustic model path
# the acoustic model, built from DSL calls both packages have: per layer
# fc(3H, linear) -> grumemory forward and fc(3H, linear) -> grumemory
# reverse, concatenated (2H wide); then fc(chars + 1, linear) ->
# warp_ctc_layer(blank = chars, norm_by_times), and the CTC error of the
# best-path decode of the scores
_DS2_MODEL = """
def acoustic_model(dsl):
    audio = dsl.data(name="audio", size={F}, is_sequence=True)
    text = dsl.data(name="text", size={V}, is_sequence=True)
    x = audio
    for _ in range({NL}):
        fwd = dsl.grumemory(input=dsl.fc(input=x, size={G}, act="linear"))
        bwd = dsl.grumemory(input=dsl.fc(input=x, size={G}, act="linear"),
                            reverse=True)
        x = dsl.concat([fwd, bwd])
    scores = dsl.fc(input=x, size={V} + 1, act="linear")
    cost = dsl.warp_ctc_layer(input=scores, label=text, size={V} + 1,
                              blank={V}, norm_by_times=True)
    dsl.evaluator("ctc_edit_distance", input=scores, label=text,
                  name="ctc_edit_distance")
    return cost, scores
""".format(F=DS2["features"], V=DS2["chars"], NL=DS2["layers"],
           G=3 * DS2["hidden"])

_DS2_SAMPLES = """
PROTOS = np.random.default_rng({seed}).normal(
    size=({V} + 1, {F})).astype(np.float32)


def utterances(rng, n):
    # (frames [t, {F}], transcript): t uniform in {lo}-{hi}, t // 10 to
    # t // 6 characters from 0-{last}; the frames are cut into one equal
    # segment per character, which holds its character's prototype for
    # its first 1 to m - 1 frames and the silence's (row {V}) after, with
    # noise: the cost can fall
    out = []
    for t in rng.integers({lo}, {hi} + 1, size=n):
        t = int(t)
        chars = rng.integers(0, {V}, size=int(rng.integers(t // 10,
                                                          t // 6 + 1)))
        m = t // len(chars)
        ids = np.full(t, {V})
        for i, c in enumerate(chars):
            ids[i * m:i * m + int(rng.integers(1, m))] = c
        frames = PROTOS[ids] + 0.5 * rng.normal(size=(t, {F}))
        out.append((frames.astype(np.float32), chars.tolist()))
    return out
""".format(seed=SEED + 17, V=DS2["chars"], F=DS2["features"],
           lo=DS2_MIN_T, hi=DS2_MAX_T, last=DS2["chars"] - 1)


# DeepSpeech2 as PaddlePaddle/models released it in 2017
# (deep_speech_2/layer.py: conv_group, rnn_group, deep_speech2): two
# conv + batch norm(brelu) layers over the spectrogram image (frequency
# rows, time columns; channel-major flat f * W + t), block_expand into a
# sequence of time columns, bidirectional batch-normed GRUs (act relu) or
# simple RNNs (one shared projection, act brelu), fc(chars + 1) into
# warp_ctc(blank = chars, norm_by_times) and a softmax mixed layer over an
# identity projection as the probability output. A conv is written as
# trainer_config_helpers.img_conv_layer writes one (non-square filter,
# stride and padding in the input's extra; He-style std from the x
# filter), through each DSL's _add, so both packages build it from the
# same text. ``convs``: (filter_x, filter_y, stride_x, stride_y, pad_x,
# pad_y) per conv layer
_DS2R_MODEL = """
def deep_speech2(dsl, mc, height, width, chars, filters, hidden, layers,
                 use_gru, convs):
    audio = dsl.data(name="audio", size=height * width, height=height,
                     width=width, channels=1)
    text = dsl.data(name="text", size=chars, is_sequence=True)
    x, c, h = audio, 1, height
    for i, (fx, fy, sx, sy, px, py) in enumerate(convs):
        conv = dsl._add(mc.LayerDef(
            name=f"conv{i}", type="exconv", act="linear", bias=False,
            inputs=[mc.Input(x.name, param_attr=mc.ParamAttr(
                initial_std=(2.0 / (fx * fx * c)) ** 0.5), extra={
                    "filter_size": fx, "filter_size_y": fy, "stride": sx,
                    "stride_y": sy, "padding": px, "padding_y": py,
                    "channels": c, "groups": 1})],
            attrs={"num_filters": filters}))
        x = dsl.batch_norm(input=conv, act="brelu", name=f"conv{i}_bn")
        c, h = filters, (h + 2 * py - fy) // sy + 1
    seq = dsl.block_expand_layer(input=x, block_x=1, block_y=h,
                                 name="conv2seq")
    for i in range(layers):
        if use_gru:
            dirs = [dsl.grumemory(
                input=dsl.batch_norm(input=dsl.fc(
                    input=seq, size=3 * hidden, act="linear",
                    bias_attr=False, name=f"rnn{i}_{d}_proj"),
                    name=f"rnn{i}_{d}_bn"),
                act="relu", reverse=d == "bwd", name=f"rnn{i}_{d}")
                for d in ("fwd", "bwd")]
        else:
            proj = dsl.batch_norm(input=dsl.fc(
                input=seq, size=hidden, act="linear", bias_attr=False,
                name=f"rnn{i}_proj"), name=f"rnn{i}_bn")
            dirs = [dsl.recurrent(input=proj, act="brelu",
                                  reverse=d == "bwd", name=f"rnn{i}_{d}")
                    for d in ("fwd", "bwd")]
        seq = dsl.concat(dirs, name=f"rnn{i}")
    scores = dsl.fc(input=seq, size=chars + 1, act="linear", name="scores")
    probs = dsl.mixed(inputs=[scores], size=chars + 1,
                      projections=[{"type": "identity"}], act="softmax",
                      name="probs")
    cost = dsl.warp_ctc_layer(input=scores, label=text, size=chars + 1,
                              blank=chars, norm_by_times=True, name="cost")
    dsl.evaluator("ctc_edit_distance", input=scores, label=text,
                  name="ctc_edit_distance")
    return cost, probs
"""


def _ds2_ns():
    from paddle_tpu_torch.config import dsl
    ns = {"np": np}
    exec(_DS2_MODEL + _DS2_SAMPLES, ns)
    dsl.reset()
    return ns, dsl


def _ds2_feeder(device="cuda"):
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (dense_vector_sequence,
                                             integer_value_sequence)
    return DataFeeder({"audio": dense_vector_sequence(DS2["features"]),
                       "text": integer_value_sequence(DS2["chars"])},
                      length_buckets=[DS2_LABEL_PAD, DS2_MAX_T],
                      device=device)


def _write_ds2_config(path, lr=DS2_LR):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import (
                dense_vector_sequence, integer_value_sequence)
            from paddle_tpu_torch.optim import Adam
        """) + _DS2_MODEL + _DS2_SAMPLES + textwrap.dedent(f"""

            cost, scores = acoustic_model(dsl)
            optimizer = Adam(learning_rate={lr})
            # audio pads to {DS2_MAX_T} frames, transcripts to
            # {DS2_LABEL_PAD} characters
            feeding = DataFeeder(
                {{"audio": dense_vector_sequence({DS2['features']}),
                  "text": integer_value_sequence({DS2['chars']})}},
                length_buckets=[{DS2_LABEL_PAD}, {DS2_MAX_T}])

            def train_reader():
                rng = np.random.default_rng({SEED})
                for _ in range({DS2_BATCHES}):
                    yield utterances(rng, {DS2_BATCH})

            def test_reader():
                rng = np.random.default_rng({SEED + 2})
                for _ in range(2):
                    yield utterances(rng, {DS2_BATCH})
        """))


# the CUDA kernel each wrapper on a traced train step launches (one a
# device launch its counters count)
_TRACED = {"lstm_seq_train": "lstm_persistent_kernel",
           "lstm_bwd_chain": "lstm_bwd_chain_kernel",
           "gru_seq_train": "gru_persistent_kernel",
           "gru_bwd_chain": "gru_bwd_chain_kernel",
           "lstm_seq_train_bf16": "lstm_bf16_kernel",
           "lstm_bwd_chain_bf16": "lstm_bf16_chain_kernel",
           "gru_seq_train_bf16": "gru_bf16_kernel",
           "gru_bwd_chain_bf16": "gru_bf16_chain_kernel",
           "ctc_fused_fwd": "ctc_fused_fwd_kernel",
           "ctc_fused_bwd": "ctc_fused_bwd_kernel",
           "adam": "adam_multi_kernel"}


def _step_trace(build_model, save_dir, optimizer, feed, cpu_ops=True,
                compute_dtype=None):
    """One training step on the card from the newest checkpoint of
    ``save_dir`` (``train_step`` on the CPU-fed batch ``feed``: forward,
    backward, update): the host-clock median of 3 after one warm step,
    each ending in a synchronise; and from one step under
    ``torch.profiler`` the device's busy time (every kernel's device time
    summed), its idle share and the five kernels that take most. The
    trace's launches by kernel stand beside the device launches the port's
    wrappers counted in that step (``expected``); ``complete`` says
    whether every one of the wrappers' launches is in the trace (where
    some are not, the busy time is low and the idle share an upper
    bound). ``cpu_ops=False`` records the device activity alone: a step of
    tens of thousands of small ops otherwise takes the profiler longer to
    summarise than the step takes to run. ``compute_dtype``: the
    trainer's (``"bfloat16"``: mixed precision)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = build_model()[0]
    params, _ = load_params(latest_checkpoint(save_dir))
    tr = SGD(cost, parameters=params, device="cuda",
             update_equation=optimizer, compute_dtype=compute_dtype)
    feed = tr._to_device(feed)

    def step():
        t0 = time.perf_counter()
        tr.train_step(feed)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def device_launches():
        return {name: c.get("step_launches", c["launches"])
                for name, c in ops.kernel_counts().items()
                if name in _TRACED}

    step()
    step_ms = statistics.median(step() for _ in range(3))
    acts = [torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if cpu_ops else [])
    before = device_launches()
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = step()
    expected = {_TRACED[k]: n - before[k]
                for k, n in device_launches().items() if n > before[k]}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    launches = {e.key[:80]: e.count for e in kernels}
    traced = {name: sum(n for k, n in launches.items() if name in k)
              for name in expected}
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(
        step_ms=step_ms, profiled_step_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_kernels=[dict(name=e.key[:80], ms=1e-3 * e.self_device_time_total,
                          count=e.count) for e in top],
        launches=launches, expected=expected, traced=traced,
        complete=traced == expected)


def train_acoustic(tmp):
    """--job train of the CTC acoustic model at DeepSpeech2's width
    (Adam(2e-4), 3 passes over 4 fixed batches of 16, --save_dir): the
    cost falls and the counts show the fused CTC kernels (once each a
    step), the residual GRU kernel, its backward chain and Adam; the
    full-width gradients (4 rows, one with an empty transcript) card
    against CPU; --job test on 2 more batches (cost, ctc_edit_distance;
    the fused CTC forward and the primal GRU kernel launched, the
    posterior pass not)."""
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, "acoustic_conf.py")
    _write_ds2_config(conf)
    save_dir = os.path.join(tmp, "acoustic_ckpt")
    t0 = time.perf_counter()
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       str(DS2_PASSES), "--seed", str(SEED), "--save_dir",
                       save_dir])
    train_s = time.perf_counter() - t0
    passes = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    costs = [float(ln.split("cost=")[1].split()[0]) for ln in passes]
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    if len(costs) != DS2_PASSES or summary["steps"] != DS2_PASSES * \
            DS2_BATCHES:
        raise AssertionError(f"acoustic train printed {passes}, {summary}")
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"acoustic pass costs {costs} do not fall")
    counts = summary["kernels"]
    for name in ("ctc_fused_fwd", "ctc_fused_bwd", "gru_seq_train",
                 "gru_bwd_chain"):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"acoustic --job train never launched "
                                 f"{name}")
    _check_opt_launches("acoustic --job train", counts, summary["steps"])
    # the layer takes the fused kernels: one forward (both chains) and one
    # posterior pass a step, no gathered kernel
    if (counts["ctc_fused_fwd"]["launches"], counts["ctc_fused_bwd"][
            "launches"], counts["ctc_alpha_fwd"]["launches"], counts[
            "ctc_bwd"]["launches"]) != (summary["steps"], summary["steps"],
                                        0, 0):
        raise AssertionError(f"acoustic --job train CTC launches {counts}")
    # the persistent route: one chain a GRU layer and step (6 x 12), no
    # per-step backward
    chains = DS2["layers"] * 2 * DS2_PASSES * DS2_BATCHES
    if (counts["gru_bwd_chain"]["launches"], counts["gru_bwd_step"][
            "launches"]) != (chains, 0):
        raise AssertionError(f"acoustic --job train: {counts['gru_bwd_chain']}"
                             f" chains (expected {chains}), "
                             f"{counts['gru_bwd_step']} backward steps")
    ns, dsl = _ds2_ns()
    batch = ns["utterances"](np.random.default_rng(SEED + 1), DS2_GRAD_ROWS)
    batch[1] = (batch[1][0], [])  # an empty transcript
    feed = _ds2_feeder("cpu")(batch)
    grads = dict(rows=DS2_GRAD_ROWS, frames=[len(f) for f, _ in batch],
                 characters=[len(c) for _, c in batch],
                 **_grads_card_vs_cpu(lambda: ns["acoustic_model"](dsl),
                                      save_dir, feed,
                                      Adam(learning_rate=DS2_LR)))
    trace = _step_trace(lambda: ns["acoustic_model"](dsl), save_dir,
                        Adam(learning_rate=DS2_LR), _ds2_feeder("cpu")(
                            ns["utterances"](np.random.default_rng(SEED),
                                             DS2_BATCH)))
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir])
    line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    test = {k: float(v) for k, v in (kv.split("=") for kv in
                                     line[len("Test: "):].split())}
    test_counts = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("test_summary "))[13:])[
        "kernels"]
    if set(test) != {"cost", "ctc_edit_distance"} or not all(
            np.isfinite(list(test.values()))):
        raise AssertionError(f"acoustic --job test printed {line}")
    for name in ("ctc_fused_fwd", "gru_seq"):
        if test_counts[name]["launches"] <= 0:
            raise AssertionError(f"acoustic --job test never launched "
                                 f"{name}")
    if test_counts["ctc_fused_bwd"]["launches"] != 0:
        raise AssertionError("acoustic --job test launched ctc_fused_bwd")
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    n_params = sum(int(np.asarray(v).size) for v in
                   load_params(latest_checkpoint(save_dir))[0].values())
    result = dict(parameters=n_params, pass_lines=passes, pass_costs=costs,
                  steps=summary["steps"], train_seconds=train_s,
                  median_step_ms=summary["median_step_ms"],
                  step_ms=summary["step_ms"], kernels=counts,
                  grad_check=grads, step_trace=trace, test=test,
                  test_kernels=test_counts)
    phase("acoustic_train", **result)
    return result


def ds2_rate_witness():
    """--job train of the acoustic model at DS2's rate, DS2_SOURCE_LR, on
    the card and on the CPU plain path from the same seed and batches:
    each run's pass costs and seconds. The CPU run shares no kernel with
    the card's, so a rise that both show is the model's at that rate."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    runs = {}
    try:
        conf = os.path.join(tmp, "acoustic_conf.py")
        _write_ds2_config(conf, lr=DS2_SOURCE_LR)
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out = _cli_inproc(["--config", conf, "--job", "train",
                               "--num_passes", str(DS2_PASSES), "--seed",
                               str(SEED), "--device", device])
            passes = [ln for ln in out.splitlines()
                      if ln.startswith("Pass ")]
            costs = [float(ln.split("cost=")[1].split()[0]) for ln in passes]
            if len(costs) != DS2_PASSES or not all(np.isfinite(costs)):
                raise AssertionError(f"witness on {device} printed {passes}")
            runs[device] = dict(pass_lines=passes, pass_costs=costs,
                                seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(learning_rate=DS2_SOURCE_LR, **runs)
    phase("ds2_rate_witness", **result)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ds2_rate_witness.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def lstm_kernels():
    """``--lstm-kernels``: phases 3 and 4 at the LSTM shapes of the paths
    (the classifier's serve (64, 1280, 128) and train (64, 1280, 100) and
    gradient check (16, 1280, 100), the tagger's (64, 128, 80)); rows in
    ``lstm_kernels.json`` in ``OUT_DIR``."""
    build.build_all(["lstm_seq"])
    H = MODEL["hidden"]
    out = dict(
        primal=[check_shape(B, h, T, (False,), seed=B + T)
                for B, h, T in [(MAX_BATCH, H, LENGTH_BUCKETS[-1]),
                                (TAG_BATCH, TAGGER["hidden"], TAG_LEN)]],
        train=[check_train_shape(B, h, T, seed=B * 11 + h)
               for B, h, T in [(TRAIN_BATCH, H, SEQLEN),
                               (GRAD_CHECK_ROWS, H, SEQLEN),
                               (TAG_BATCH, TAGGER["hidden"], TAG_LEN)]])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "lstm_kernels.json"), "w") as f:
        json.dump(out, f, indent=1)


def _lstm_route_keys(row, prefix):
    """The LSTM forward's route and both routes' times for its entry."""
    return dict(kernel_route="persistent",
                device_ms=row[prefix + "device_ms"],
                per_step_ms=row["per_step_" + prefix + "ms"],
                per_step_device_ms=row["per_step_" + prefix + "device_ms"])


def _lstm_chain_keys(row):
    """The LSTM chain's device time, the per-step loop's and both routes'
    whole backward for its entry."""
    return dict(kernel_route="persistent", device_ms=row["chain_device_ms"],
                step_loop_ms=row["step_loop_ms"], backward_ms=row["bwd_ms"],
                per_step_backward_ms=row["per_step_bwd_ms"])


def _cell_route_keys(row):
    """The GRU cell's route and both routes' times for its entry."""
    return dict(kernel_route="cluster", device_ms=row["device_ms"],
                two_launch_ms=row["two_launch_ms"],
                two_launch_device_ms=row["two_launch_device_ms"],
                plan=row["plan"])


# ------------------------------------------------------ 12. the image slice
def _resnet_net():
    """The port's ResNet graph at RESNET, executed up to its softmax."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.models import resnet
    dsl.reset()
    cost, out, _ = resnet(**RESNET)
    return Network(dsl.current_graph(), outputs=[out.name]), cost, out.name


def _conv_fc_flops(net, B):
    """The forward's operations from the graph's shapes: 2 B Ho Wo fs^2
    (Cin / g) Cout over every convolution, plus 2 B in out over the fc."""
    total = 0
    for name in net.order:
        layer = net.model.layers[name]
        if layer.type not in ("exconv", "cudnn_conv", "conv", "fc"):
            continue
        out = net.shape_infos[name]
        for suffix, pname in net._layer_params[name].items():
            if suffix == "wbias":
                continue
            shape = net.param_specs[pname].shape
            if layer.type == "fc":
                total += 2 * B * shape[0] * shape[1]
            else:  # HWIO (fsy, fs, c / g, nf)
                total += 2 * B * out.height * out.width * int(
                    np.prod(shape))
    return total


def _forward_trace(fn):
    """One call of ``fn`` under ``torch.profiler``: the device's busy ms
    (every kernel's device time), its idle share of the wall time, and
    the five kernels that take most."""
    fn()
    torch.cuda.synchronize()
    kernels, wall_ms = _traced(fn, 1)
    kernels = [e for e in kernels if e.self_device_time_total > 0]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                kernels=len(kernels), launches=sum(e.count for e in kernels),
                top_kernels=[dict(name=e.key[:80],
                                  ms=1e-3 * e.self_device_time_total,
                                  count=e.count) for e in top])


def _close(where, got, want):
    """got within rtol 1e-4 / atol 1e-5 of want; the max abs error."""
    torch.testing.assert_close(got, want, **TOL,
                               msg=lambda m: f"{where}: {m}")
    return (got - want).abs().max().item() if got.numel() else 0.0


def _layer_share(where, got, want):
    """got against want: within rtol 1e-4 and an atol of 1e-5 times
    want's largest |value| (at least 1e-5), the non-finite entries (NaN,
    +inf, -inf) in the same places; the largest share of that tolerance
    an entry takes."""
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(got), test(want)):
            raise AssertionError(f"{where}: {test.__name__} in other places")
    live = torch.isfinite(want)
    got, want = got[live], want[live]
    if not want.numel():
        return 0.0
    atol = TOL["atol"] * max(1.0, want.abs().max().item())
    share = ((got - want).abs()
             / (atol + TOL["rtol"] * want.abs())).max().item()
    if not share <= 1.0:
        raise AssertionError(f"{where}: {share} times the tolerance")
    return share


def _layers_on_card(where, net, dev_params, outs_cpu, train,
                    below_overflow=False):
    """Each layer on the card from the CPU run's outputs of the layers it
    reads, against the CPU run's output of that layer (``_layer_share``):
    every kernel held at the values the whole stack gives it, whatever
    the rounding upstream. ``below_overflow`` takes only the layers whose
    inputs and output are finite throughout on the CPU. The largest share
    of the tolerance and the number of layers compared."""
    share, compared = 0.0, 0
    for name in net.order:
        layer = net.model.layers[name]
        if layer.type == "data":
            continue
        reads = {i: Argument(outs_cpu[i].value.cuda())
                 for i in layer.input_names()}
        want = outs_cpu[name].value.cuda()
        if below_overflow and not all(
                torch.isfinite(t).all() for t in
                [want] + [a.value for a in reads.values()]):
            continue
        with torch.no_grad():
            got, _ = net.apply_layer(name, dev_params, reads, train=train)
        share = max(share, _layer_share(f"{where} {name}", got.value, want))
        compared += 1
    return share, compared


def _logits(outs, params):
    """The fc's pre-softmax output, from its input (the global pool) and
    its weights, as ``layers/common.py``'s fc computes it."""
    x = outs["global_pool"].value
    return x.reshape(x.shape[0], -1) @ params["_output.w0"] \
        + params["_output.wbias"]


def check_resnet():
    """ResNet-50 at entry()'s shape on the card against the port's CPU
    path, the same parameters (``init_params`` from a seeded generator)
    and feed [8, 224, 224, 3], three ways: (a) ``train=True``, the output
    and the 106 state updates (rtol 1e-4 / atol 1e-5); (b)
    ``train=False`` on (a)'s moving statistics, the output finite and
    close; (c) ``train=False`` at ``init_params``, as entry() runs it
    (moving variance 0): NaN in the same places of the output. In each,
    every layer is also run on the card from the CPU run's values of the
    layers it reads and held to the CPU's output of that layer
    (``_layer_share``), the fc's pre-softmax output too: (b)'s softmax
    saturates (the moving variance after one update is a tenth of the
    batch's, so values grow through the stack, the logits to ~1e25), and
    (c)'s values grow by 1 / sqrt(eps) a batch norm until they overflow
    (its output is all NaN; the layers below the overflow are compared),
    so their outputs alone would hold little. The forward at (b): CUDA
    events and device time (median of RESNET_REPS), a profiled call's
    idle share and top kernels, beside its f32 operations bound."""
    t0 = time.perf_counter()
    net, _, name = _resnet_net()
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cpu")
    image = torch.randn((RESNET_BATCH, RESNET["image_size"],
                         RESNET["image_size"], 3),
                        generator=torch.Generator().manual_seed(SEED + 1))
    dev_params = {k: v.cuda() for k, v in params.items()}
    dev_feed = {"image": Argument(image.cuda())}
    cpu_feed = {"image": Argument(image)}

    def run(p, feed, train):
        with torch.no_grad():
            return net.apply_with_state(p, feed, train=train)

    def logits_on_card(where, outs_cpu, p, dev_p):
        want = _logits(outs_cpu, p).cuda()
        got = _logits({"global_pool": Argument(
            outs_cpu["global_pool"].value.cuda())}, dev_p)
        if not (want.std(dim=1) > 0).all():
            raise AssertionError(f"{where}: the logits are flat in a row")
        return _layer_share(f"{where} logits", got, want)

    row = dict(batch=RESNET_BATCH, **RESNET,
               parameters=sum(int(np.prod(s.shape))
                              for s in net.param_specs.values()),
               stem_pool=[net.shape_infos["stem_pool"].channels,
                          net.shape_infos["stem_pool"].height,
                          net.shape_infos["stem_pool"].width],
               res5c_add=[net.shape_infos["res5c_add"].channels,
                          net.shape_infos["res5c_add"].height,
                          net.shape_infos["res5c_add"].width],
               layers=len(net.order) - 1)
    ya, ua = run(dev_params, dev_feed, True)
    ya_c, ua_c = run(params, cpu_feed, True)
    if len(ua) != 106 or sorted(ua) != sorted(ua_c):
        raise AssertionError(f"resnet (a): {len(ua)} state updates")
    row["a_max_abs_err"] = _close("resnet (a) output", ya[name].value.cpu(),
                                  ya_c[name].value)
    row["a_updates_max_abs_err"] = max(
        _close(f"resnet (a) {k}", u.cpu(), ua_c[k]) for k, u in ua.items())
    del ya
    row["a_layers_tol_share"], row["a_layers"] = _layers_on_card(
        "resnet (a)", net, dev_params, ya_c, True)
    row["a_logits_tol_share"] = logits_on_card("resnet (a)", ya_c, params,
                                               dev_params)
    del ya_c
    b_params, b_params_c = {**dev_params, **ua}, {**params, **ua_c}
    yb, ub = run(b_params, dev_feed, False)
    yb_c, _ = run(b_params_c, cpu_feed, False)
    if ub or not torch.isfinite(yb_c[name].value).all():
        raise AssertionError("resnet (b): updates at test, or not finite")
    row["b_max_abs_err"] = _close("resnet (b) output", yb[name].value.cpu(),
                                  yb_c[name].value)
    row["b_softmax_top_mean"] = yb_c[name].value.max(dim=1)[0].mean().item()
    del yb
    row["b_layers_tol_share"], row["b_layers"] = _layers_on_card(
        "resnet (b)", net, b_params, yb_c, False)
    row["b_logits_tol_share"] = logits_on_card("resnet (b)", yb_c,
                                               b_params_c, b_params)
    row["b_logits_abs_max"] = _logits(yb_c, b_params_c).abs().max().item()
    del yb_c, ua_c, b_params_c
    yc, _ = run(dev_params, dev_feed, False)
    yc_c, _ = run(params, cpu_feed, False)
    nan = torch.isnan(yc_c[name].value)
    if not torch.equal(torch.isnan(yc[name].value.cpu()), nan):
        raise AssertionError("resnet (c): NaN in other places")
    row["c_nan_share"] = float(nan.float().mean())
    del yc
    row["c_layers_tol_share"], row["c_layers"] = _layers_on_card(
        "resnet (c)", net, dev_params, yc_c, False, below_overflow=True)
    if not row["c_layers"]:
        raise AssertionError("resnet (c): no layer below the overflow")
    del yc_c

    def forward():
        run(b_params, dev_feed, False)

    flops = _conv_fc_flops(net, RESNET_BATCH)
    row.update(
        fwd_ms=_time_ms(forward, reps=RESNET_REPS),
        fwd_device_ms=_device_ms(forward, None, calls=RESNET_REPS)[0],
        fwd_flops=flops, fwd_bound_ms=1e3 * flops / F32_FLOPS,
        fwd_bound_by="operations", fwd_trace=_forward_trace(forward),
        seconds=time.perf_counter() - t0)
    phase("resnet_check", **row)
    return row, net, params


@contextlib.contextmanager
def _relu_masks(record=None, replay=None):
    """The executor's ReLU with its masks recorded (appended to
    ``record``, in call order) or replayed (``replay``: an earlier run's
    masks, applied as ``x * mask``, whose gradient is the mask). The
    executor looks ``apply_activation`` up at each layer, so the patch
    reaches every ReLU of the graph; a replay must use up every mask."""
    from paddle_tpu_torch.layers import activations
    plain = activations.apply_activation
    left = iter(replay or ())

    def act(kind, value, mask):
        if kind != "relu" or replay is None:
            if kind == "relu" and record is not None:
                record.append(value.detach() > 0)
            return plain(kind, value, mask)
        return value * next(left).to(value.device, value.dtype)

    activations.apply_activation = act
    try:
        yield
    finally:
        activations.apply_activation = plain
    if replay is not None and next(left, None) is not None:
        raise AssertionError("resnet: a recorded ReLU mask was not used")


def check_resnet_training(net, params):
    """ResNet-50 training at full width: one batch of RESNET_GRAD_BATCH
    rows, the loss and every parameter gradient, card against CPU, per
    tensor within 1e-3 of the largest entry + 1e-6 (the loss within 1e-5
    relative), three ways:

    - float64 on both;
    - float32 with the float64 run's ReLU masks replayed on both (each
      within the tolerance of the other and of the float64 gradients):
      the float32 kernels the step runs, held at full width;
    - float32 as the step runs it: the loss, the moving statistics (rtol
      1e-4 / atol 1e-5) and the statistics folded into the card's
      parameters by ``train_step`` (the optimizer's update, then the
      state). Its gradients' distance from the float64 ones is reported
      per device, as a multiple of the tolerance, and the card's may be at
      most twice the CPU's + 1: in float32 a pre-activation within
      rounding of 0 takes the other side of a ReLU than in float64 and
      routes a whole gradient entry elsewhere, so at init both devices
      miss the exact gradients by ~150 times the tolerance, alike
      (``tests/test_torch_resnet.py`` shows the same miss in the JAX
      package, and its disappearance when the masks are replayed).

    Then the Momentum(0.01, 0.9) step at RESNET_BATCH on the card: host
    clock to a synchronise, median of RESNET_REPS after a warm step, one
    ``momentum_multi_kernel`` launch a step, a profiled step's idle
    share."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import dense_vector, integer_value
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.optim import Momentum
    from paddle_tpu_torch.trainer.trainer import SGD
    t0 = time.perf_counter()
    size = RESNET["image_size"]
    feeder = DataFeeder({"image": dense_vector(3 * size * size),
                         "label": integer_value(RESNET["classes"])},
                        device="cpu")
    rng = np.random.default_rng(SEED + 2)

    def batch(n):
        return feeder([(rng.normal(size=3 * size * size).astype(np.float32),
                        int(rng.integers(0, RESNET["classes"])))
                       for _ in range(n)])

    dsl.reset()
    cost = resnet(**RESNET)[0]
    feed = batch(RESNET_GRAD_BATCH)
    runs, masks, seconds = {}, [], {}
    for key, dev, dtype, relu in (
            ("cuda64", "cuda", torch.float64, dict(record=masks)),
            ("cpu64", "cpu", torch.float64, {}),
            ("cuda_m", "cuda", torch.float32, dict(replay=masks)),
            ("cpu_m", "cpu", torch.float32, dict(replay=masks)),
            ("cuda", "cuda", torch.float32, {}),
            ("cpu", "cpu", torch.float32, {})):
        t1 = time.perf_counter()
        tr = SGD(cost, parameters=params, device=dev,
                 update_equation=Momentum(learning_rate=0.01, momentum=0.9))
        tr.params = {k: v.to(dtype) for k, v in tr.params.items()}
        dfeed = tr._to_device(feed)
        for arg in dfeed.values():
            if arg.value.is_floating_point():
                arg.value = arg.value.to(dtype)
        with _relu_masks(**relu):
            _, loss, grads, updates = tr.loss_and_grads(dfeed)
        runs[key] = (float(loss),
                     {k: g.cpu().double() for k, g in grads.items()},
                     {k: u.cpu() for k, u in updates.items()})
        if key == "cuda":  # the step folds the same statistics in
            tr.train_step(dfeed)
            fold_err = max(_close(f"resnet step {k}", tr.params[k].cpu(), u)
                           for k, u in runs[key][2].items())
        del tr
        seconds[key] = time.perf_counter() - t1
    if not masks:
        raise AssertionError("resnet: no ReLU mask recorded")
    for suffix in ("64", "_m", ""):
        lg, lc = runs["cuda" + suffix][0], runs["cpu" + suffix][0]
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"resnet loss {lg} on the card, {lc} on "
                                 f"the CPU ({suffix or '32'})")
    exact = runs["cpu64"][1]
    limit = {k: 1e-3 * w.abs().max().item() + 1e-6 for k, w in exact.items()}

    def multiple(key, against=exact):
        """The largest distance of run ``key``'s gradients from
        ``against``'s, per tensor as a multiple of the tolerance."""
        return max((runs[key][1][k] - w).abs().max().item() / limit[k]
                   for k, w in against.items())

    grad_err = max((runs["cuda64"][1][k] - w).abs().max().item()
                   for k, w in exact.items())
    checked = dict(cuda64=multiple("cuda64"), cuda_m=multiple("cuda_m"),
                   cpu_m=multiple("cpu_m"),
                   cuda_m_vs_cpu_m=multiple("cuda_m", runs["cpu_m"][1]))
    for what, m in checked.items():
        if not m <= 1.0:
            raise AssertionError(f"resnet gradients {what}: {m} times the "
                                 "tolerance")
    f32_vs_64 = {dev: multiple(dev) for dev in ("cuda", "cpu")}
    if not f32_vs_64["cuda"] <= 2 * f32_vs_64["cpu"] + 1:
        raise AssertionError(f"resnet float32 gradients: {f32_vs_64} times "
                             "the tolerance from float64, card and CPU")
    sg, sc = runs["cuda"][2], runs["cpu"][2]
    if len(sc) != 106:
        raise AssertionError(f"resnet: {len(sc)} moving statistics")
    stats_err = max(_close(f"resnet statistics {k}", sg[k], w)
                    for k, w in sc.items())
    lg, lc = runs["cuda"][0], runs["cpu"][0]
    del runs, masks
    t1 = time.perf_counter()
    tr = SGD(cost, parameters=params, device="cuda",
             update_equation=Momentum(learning_rate=0.01, momentum=0.9))
    dfeed = tr._to_device(batch(RESNET_BATCH))

    def step():
        t0 = time.perf_counter()
        tr.train_step(dfeed)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    step()
    ops.reset_kernel_counts()
    step_ms = [step() for _ in range(RESNET_REPS)]
    launches = ops.kernel_counts()["momentum"]["launches"]
    if launches != RESNET_REPS:
        raise AssertionError(f"resnet: {launches} momentum launches in "
                             f"{RESNET_REPS} steps")
    flops = _conv_fc_flops(net, RESNET_BATCH)
    row = dict(grad_batch=RESNET_GRAD_BATCH, loss_cuda=lg, loss_cpu=lc,
               grad64_max_abs_err=grad_err,
               grad_limit_multiple=checked,
               grad32_vs_64_limit_multiple=f32_vs_64,
               stats_max_abs_err=stats_err,
               step_fold_max_abs_err=fold_err,
               step_batch=RESNET_BATCH, step_ms=statistics.median(step_ms),
               step_ms_all=step_ms, momentum_launches=launches,
               step_flops=3 * flops, step_bound_ms=3e3 * flops / F32_FLOPS,
               step_trace=_forward_trace(step))
    seconds["step"] = time.perf_counter() - t1
    row.update(run_seconds=seconds, seconds=time.perf_counter() - t0)
    phase("resnet_train_check", **row)
    return row


def _write_lenet_config(path):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.data.types import (dense_vector,
                                                     integer_value)
            from paddle_tpu_torch.models import lenet_mnist
            from paddle_tpu_torch.optim import Momentum

            dsl.reset()
            cost, out, _ = lenet_mnist()
            outputs = [out]
            optimizer = Momentum(learning_rate=0.01, momentum=0.9)
            feeding = {{"pixel": dense_vector(784),
                        "label": integer_value(10)}}


            def digits(seed, batches):
                # each class a fixed random prototype plus noise
                protos = np.random.default_rng({SEED}).normal(
                    size=(10, 784))
                rng = np.random.default_rng(seed)
                for _ in range(batches):
                    y = rng.integers(0, 10, size={LENET_BATCH})
                    x = protos[y] + 0.5 * rng.normal(size=({LENET_BATCH},
                                                           784))
                    yield [(x[i].astype(np.float32), int(y[i]))
                           for i in range({LENET_BATCH})]


            def train_reader():
                return digits({SEED}, {LENET_BATCHES})


            def test_reader():
                return digits({SEED + 1}, 2)
        """))


def train_lenet(tmp):
    """LeNet through the normal entry points: ``--job train`` (Momentum
    0.01 / 0.9, LENET_PASSES passes over LENET_BATCHES fixed batches; the
    classification error falls, one momentum launch a step), ``--job
    test``, ``--job merge``, then the merged model in the predictor on the
    card and on the CPU: single rows and a batch of LENET_SERVE_BATCH give
    the CPU's scores within 1e-5."""
    from paddle_tpu_torch.data.types import dense_vector
    from paddle_tpu_torch.serving.predictor import ServingPredictor
    t0 = time.perf_counter()
    conf = os.path.join(tmp, "lenet_conf.py")
    _write_lenet_config(conf)
    save_dir = os.path.join(tmp, "lenet_ckpt")
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       str(LENET_PASSES), "--seed", str(SEED), "--save_dir",
                       save_dir])
    passes = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    errs = [float(ln.split("classification_error=")[1].split()[0])
            for ln in passes]
    costs = [float(ln.split("cost=")[1].split()[0]) for ln in passes]
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    if len(errs) != LENET_PASSES or not errs[-1] < errs[0]:
        raise AssertionError(f"LeNet classification error {errs} does not "
                             "fall")
    _check_opt_launches("LeNet --job train", summary["kernels"],
                        summary["steps"], "momentum")
    test_out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                            save_dir])
    test_line = next(ln for ln in test_out.splitlines()
                     if ln.startswith("Test: "))
    model = os.path.join(tmp, "lenet.ptmodel")
    _cli_inproc(["--config", conf, "--job", "merge", "--save_dir", save_dir,
                 "--model_path", model])
    feeding = {"pixel": dense_vector(784)}
    preds = {dev: ServingPredictor.from_merged(
        model, feeding, batch_buckets=[1, LENET_SERVE_BATCH], device=dev)
        for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(SEED + 3)
    rows = [(rng.normal(size=784).astype(np.float32),)
            for _ in range(LENET_SERVE_BATCH)]
    err = 0.0
    for group in ([rows[0]], [rows[1]], rows):
        got, want = (preds[d].predict_rows(group)[0] for d in ("cuda",
                                                               "cpu"))
        for k in want:
            e = float(np.abs(got[k][:len(group)]
                             - want[k][:len(group)]).max())
            if not e <= 1e-5:
                raise AssertionError(f"LeNet served {k}: card against CPU "
                                     f"{e}")
            err = max(err, e)
    result = dict(pass_costs=costs, pass_errors=errs,
                  steps=summary["steps"],
                  median_step_ms=summary["median_step_ms"],
                  kernels=summary["kernels"], test=test_line,
                  served_max_abs_err=err,
                  seconds=time.perf_counter() - t0)
    phase("lenet", **result)
    return result


def check_image(tmp):
    """Phase 12, the image slice: ResNet-50 (a), (b), (c) and its forward
    time, its training check and step time, LeNet through the CLI and the
    predictor."""
    resnet_row, net, params = check_resnet()
    resnet_train = check_resnet_training(net, params)
    del net, params
    return dict(resnet=resnet_row, resnet_train=resnet_train,
                lenet=train_lenet(tmp))


def image_slice():
    """``--image``: phase 12 alone; rows in ``image_slice.json`` in
    ``OUT_DIR``."""
    build.build_all(["opt_update"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        out = check_image(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "image_slice.json"), "w") as f:
        json.dump(out, f, indent=1)


# ------------------------------------------- 13. the rest of training
CARRY_ROWS = 16       # (b): the carried state, card against the CPU
ASYNC_REPEATS = 5     # (c): interleaved repeats of each loading mode
# (d): 2 passes of 4 batches, a save every 2 batches, the kill at step 7
# (pass 1, batch 2: after the save at pass 1's batch 2, before batch 4's)
RESUME_PASSES, RESUME_CADENCE, RESUME_KILL_AT = 2, 2, 7
DROP_PASSES = 3       # (e): the dropout classifier's cost over 3 passes
EVAL_BATCH = 32       # (f): --job test over 2 batches of 32
DROP_RATE = 0.5


def _classifier_samples():
    """The main config's train_reader: TRAIN_BATCHES fixed batches of
    TRAIN_BATCH samples (lengths 1-SEQLEN, labels from a rule on the
    ids)."""
    rng = np.random.default_rng(SEED)
    for _ in range(TRAIN_BATCHES):
        batch = []
        for n in rng.integers(1, SEQLEN + 1, size=TRAIN_BATCH):
            ids = rng.integers(0, MODEL["vocab_size"], size=int(n))
            low = (ids < MODEL["vocab_size"] // 2).mean()
            batch.append((ids.tolist(), int(low > 0.5)))
        yield batch


def _classifier_feeder(device):
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    return DataFeeder({"words": integer_value_sequence(MODEL["vocab_size"]),
                       "label": integer_value(MODEL["classes"])},
                      pad_multiple=SEQLEN, device=device)


def _classifier_trainer(device, optimizer=None, **kw):
    """The h=1280 classifier's SGD on ``device``, its parameters from
    SEED (the same on every device)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = lstm_text_classifier(**MODEL)[0]
    params = SGD(cost, device="cpu", seed=SEED,
                 update_equation=Adam(learning_rate=2e-3)).params
    return SGD(cost, parameters=params, device=device,
               update_equation=optimizer or Adam(learning_rate=2e-3), **kw)


_DROPOUT_MODEL = """
def dropout_classifier(dsl):
    # lstm_text_classifier with dsl.dropout between the max-over-time
    # pooling and the softmax fc
    words = dsl.data(name="words", size={vocab}, is_sequence=True)
    label = dsl.data(name="label", size={classes})
    x = dsl.embedding(input=words, size={embed}, vocab_size={vocab},
                      name="embed")
    for i in range({layers}):
        proj = dsl.fc(input=x, size={hidden} * 4, act="linear",
                      name=f"lstm{{i}}_proj")
        x = dsl.lstmemory(input=proj, name=f"lstm{{i}}")
    pooled = dsl.pooling(input=x, pooling_type="max", name="pool_time")
    dropped = dsl.dropout(pooled, {rate}, name="drop")
    out = dsl.fc(input=dropped, size={classes}, act="softmax", name="output")
    cost = dsl.classification_cost(input=out, label=label, name="cost")
    return cost, out, label
""".format(vocab=MODEL["vocab_size"], classes=MODEL["classes"],
           embed=MODEL["embed_dim"], hidden=MODEL["hidden"],
           layers=MODEL["num_layers"], rate=DROP_RATE)


def _write_dropout_config(path, evaluators=False):
    """The dropout classifier's config (the main config's data and Adam);
    with ``evaluators`` it declares classification_error, auc,
    precision_recall, pnpair and three printers, and a test reader of 2
    batches of EVAL_BATCH."""
    evals = textwrap.dedent("""
        dsl.evaluator("classification_error", out, label=label, name="err")
        dsl.evaluator("auc", out, label=label, name="auc")
        dsl.evaluator("precision_recall", out, label=label, name="pr")
        dsl.evaluator("pnpair", out, label=label, name="pnpair")
        dsl.evaluator("max_id_printer", out, name="maxid")
        dsl.evaluator("classification_error_printer", out, label=label,
                      name="errs")
        dsl.evaluator("value_printer", out, name="values")
    """) if evaluators else ""
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import (
                integer_value, integer_value_sequence)
            from paddle_tpu_torch.optim import Adam
        """) + _DROPOUT_MODEL + textwrap.dedent(f"""
            cost, out, label = dropout_classifier(dsl)
            outputs = [out]
            optimizer = Adam(learning_rate=2e-3)
            feeding = DataFeeder(
                {{"words": integer_value_sequence({MODEL['vocab_size']}),
                  "label": integer_value({MODEL['classes']})}},
                pad_multiple={SEQLEN})

            def _batches(seed, n, size):
                rng = np.random.default_rng(seed)
                for _ in range(n):
                    batch = []
                    for k in rng.integers(1, {SEQLEN + 1}, size=size):
                        ids = rng.integers(0, {MODEL['vocab_size']},
                                           size=int(k))
                        low = (ids < {MODEL['vocab_size'] // 2}).mean()
                        batch.append((ids.tolist(), int(low > 0.5)))
                    yield batch

            def train_reader():
                return _batches({SEED}, {TRAIN_BATCHES}, {TRAIN_BATCH})

            def test_reader():
                return _batches({SEED + 5}, 2, {EVAL_BATCH})
        """) + evals)


def _cli_run(args, env=None, timeout=900, expect=0):
    """One CLI process: (return code, stdout)."""
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=env)
    if res.returncode != expect:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise AssertionError(f"trainer.cli {' '.join(args[:4])} exited "
                             f"{res.returncode}, expected {expect}")
    return res.stdout


def _summary(out, key="train_summary"):
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith(key + " "))[len(key) + 1:])


def _pass_costs(out):
    return [float(ln.split("cost=")[1].split()[0])
            for ln in out.splitlines() if ln.startswith("Pass ")]


def _max_rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _training_accum(conf, mom_conf):
    """(a): one batch's gradient at k = 2 and 4 against the whole batch's
    on the card; 2 passes of --job train at k = 2 against k = 1 (pass
    costs within 1e-4 relative), the routes at the microbatch's rows and
    the launches (one optimizer launch a step, a reverse chain per layer
    and microbatch). The passes run the config with the CLI's default
    Momentum: Adam's first steps are sign-like (m / sqrt(v) = +-1), so
    an entry whose gradient is roundoff takes a whole step of either sign
    and the trajectory measures that, not the accumulation; the Adam
    config's k = 2 pass costs are recorded beside k = 1's (phase 8's,
    or run here)."""
    from paddle_tpu_torch import ops
    trainer = _classifier_trainer("cuda")
    feed = trainer._to_device(_classifier_batch())
    _, loss, whole, _, _ = trainer._grads(feed, seed=0)
    row = dict(loss=float(loss), routes={
        rows: L.lstm_route(rows, MODEL["hidden"])
        for rows in (TRAIN_BATCH, TRAIN_BATCH // 2, TRAIN_BATCH // 4)})
    for k in (2, 4):
        ops.reset_kernel_counts()
        metrics, grads, _ = trainer._accum_grads(feed, k, seed=0)
        torch.cuda.synchronize()
        counts = ops.kernel_counts()
        if counts["lstm_bwd_chain"]["launches"] != k * MODEL["num_layers"]:
            raise AssertionError(f"accumulation at k={k}: {counts}")
        errs = {}
        for name, w in whole.items():
            err = (grads[name] - w).abs().max().item()
            limit = 1e-4 * w.abs().max().item() + 1e-5
            errs[name] = err
            if not err <= limit:
                raise AssertionError(f"accumulated gradient {name} at k={k}:"
                                     f" {err} > {limit}")
        loss_err = abs(float(metrics["cost"]) - float(loss)) / abs(
            float(loss))
        if not loss_err <= 1e-5:
            raise AssertionError(f"accumulated loss at k={k}: rel err "
                                 f"{loss_err}")
        row[f"k{k}"] = dict(max_abs_err=max(errs.values()),
                            loss_rel_err=loss_err,
                            lstm_seq_train_launches=counts[
                                "lstm_seq_train"]["launches"],
                            lstm_bwd_chain_launches=counts[
                                "lstm_bwd_chain"]["launches"])
    del trainer, whole, grads
    runs = {}
    for k in (1, 2):
        out = _cli_inproc(["--config", mom_conf, "--job", "train",
                           "--num_passes", "2", "--seed", str(SEED),
                           "--grad_accum_steps", str(k)])
        runs[k] = (_pass_costs(out), _summary(out))
    (c1, s1), (c2, s2) = runs[1], runs[2]
    rel = _max_rel(c2, c1)
    if not (len(c2) == len(c1) == 2 and rel <= 1e-4):
        raise AssertionError(f"k=2 pass costs {c2} against k=1 {c1}: rel "
                             f"{rel}")
    steps, counts = s2["steps"], s2["kernels"]
    _check_opt_launches("--grad_accum_steps 2", counts, steps, "momentum")
    _check_lstm_chains("--grad_accum_steps 2", counts,
                       2 * MODEL["num_layers"] * steps)
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       "2", "--seed", str(SEED), "--grad_accum_steps", "2"])
    adam_k2, adam_summary = _pass_costs(out), _summary(out)
    _check_opt_launches("Adam --grad_accum_steps 2", adam_summary["kernels"],
                        adam_summary["steps"])
    row.update(pass_costs_k2=c2, pass_costs_k1=c1, pass_cost_rel_err=rel,
               steps=steps, median_step_ms_k1=s1["median_step_ms"],
               median_step_ms_k2=s2["median_step_ms"],
               adam_pass_costs_k2=adam_k2,
               adam_median_step_ms_k2=adam_summary["median_step_ms"],
               kernels=counts, adam_kernels=adam_summary["kernels"])
    return row


def _training_carry():
    """(b): 3 batches of CARRY_ROWS rows with ``prev_batch_state`` on the
    card and on the CPU plain path, from the same parameters (Momentum,
    the CLI's default: Adam's first steps are sign-like, and a gradient
    of roundoff would flip a step): every batch's cost within 1e-4
    relative and the carried h and c of both layers within 1e-4 of the
    largest + 1e-5; the LSTM's residual kernel launched with a non-zero
    h0 from the second batch on."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.optim import Momentum
    rng = np.random.default_rng(SEED + 3)
    feeder = _classifier_feeder("cpu")
    feeds = [feeder([(rng.integers(0, MODEL["vocab_size"], size=int(n))
                      .tolist(), int(rng.integers(0, 2)))
                     for n in rng.integers(1, SEQLEN + 1, size=CARRY_ROWS)])
             for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        tr = _classifier_trainer(device, Momentum(learning_rate=0.01,
                                                  momentum=0.9),
                                 prev_batch_state=True)
        costs, carried, h0_max, launches = [], [], [], []
        for i, feed in enumerate(feeds):
            h0 = tr._carried
            h0_max.append(0.0 if h0 is None else max(
                float(h0[n][0].abs().max()) for n in h0))
            ops.reset_kernel_counts()
            costs.append(float(tr.train_step(tr._to_device(feed),
                                             seed=i)["cost"]))
            launches.append(ops.kernel_counts()["lstm_seq_train"]["launches"])
            carried.append({n: tuple(t.cpu() for t in st)
                            for n, st in tr._carried.items()})
        runs[device] = (costs, carried, h0_max, launches)
        del tr
    (cc, ccar, h0c, lc), (pc, pcar, _, _) = runs["cuda"], runs["cpu"]
    rel = _max_rel(cc, pc)
    if not rel <= 1e-4:
        raise AssertionError(f"prev_batch_state costs card {cc}, CPU {pc}")
    if not (h0c[0] == 0.0 and min(h0c[1:]) > 0
            and lc == [MODEL["num_layers"]] * 3):
        raise AssertionError(f"prev_batch_state: h0 max {h0c}, "
                             f"lstm_seq_train launches {lc}")
    err = 0.0
    for got, want in zip(ccar, pcar):
        for n in want:
            for g, w in zip(got[n], want[n]):
                e = (g - w).abs().max().item()
                if not e <= 1e-4 * w.abs().max().item() + 1e-5:
                    raise AssertionError(f"carried state of {n}: {e}")
                err = max(err, e)
    return dict(rows=CARRY_ROWS, costs_cuda=cc, costs_cpu=pc,
                cost_rel_err=rel, carried_max_abs_err=err, h0_max_abs=h0c,
                lstm_seq_train_launches=lc, optimizer="Momentum(0.01, 0.9)")


def _training_async():
    """(c): one pass of the 4 batches with synchronous loading and with
    ``async_load_data`` (depth 2), ASYNC_REPEATS of each interleaved (S A
    A S ...), each from the same parameters: every run's final parameters
    bit-equal to the first synchronous run's; each run's wall ms a step
    (the wait for the batch and the step), its median over the steps; the
    median and the spread of those over the repeats."""
    feeder = _classifier_feeder("cuda")
    ref, per_mode = None, {"sync": [], "async": []}
    order = [m for i in range(ASYNC_REPEATS)
             for m in (("sync", "async") if i % 2 == 0
                       else ("async", "sync"))]
    for mode in order:
        tr = _classifier_trainer("cuda")
        tr.train(_classifier_samples, feeder=feeder, num_passes=1,
                 async_load_data=mode == "async", prefetch_depth=2)
        torch.cuda.synchronize()
        params = {k: v.detach().clone() for k, v in tr.params.items()}
        if ref is None:
            ref = params
        elif not all(torch.equal(params[k], ref[k]) for k in ref):
            raise AssertionError(f"{mode} loading: the parameters differ "
                                 "from the first synchronous run's")
        walls = [1e3 * (w + s) for w, s in zip(tr.data_wait_seconds,
                                                tr.step_seconds)]
        per_mode[mode].append(dict(
            wall_ms=statistics.median(walls),
            step_ms=statistics.median(1e3 * s for s in tr.step_seconds),
            wait_ms=statistics.median(1e3 * w
                                      for w in tr.data_wait_seconds)))
        del tr
    row = dict(order=order, bit_equal=True, repeats=per_mode)
    for mode, reps in per_mode.items():
        walls = [r["wall_ms"] for r in reps]
        row[f"{mode}_wall_ms_median"] = statistics.median(walls)
        row[f"{mode}_wall_ms_spread"] = [min(walls), max(walls)]
        row[f"{mode}_wait_ms_median"] = statistics.median(
            r["wait_ms"] for r in reps)
    return row


def _training_save_times(tmp):
    """The caller's wall time of one save of the classifier's parameters
    and Adam slots (3 x 24,186,882 floats) in the foreground (serialise,
    fsync, rename) and in the background (the copy to the host; the
    writer's own time to the end of its flush beside it), 2 of each
    interleaved (F B B F)."""
    from paddle_tpu_torch.dist.checkpoint import Checkpointer
    tr = _classifier_trainer("cuda")
    tr.train_step(tr._to_device(_classifier_batch()), seed=0)
    torch.cuda.synchronize()
    times = {"foreground": [], "background": [], "background_flush": []}
    for i, bg in enumerate((False, True, True, False)):
        ck = Checkpointer(os.path.join(tmp, f"save_{i}"), background=bg)
        t0 = time.perf_counter()
        ck.save(lambda: tr.params, lambda: tr.opt_state, pass_id=0,
                trainer_state=tr._trainer_state_for_save)
        t1 = time.perf_counter()
        ck.close()
        t2 = time.perf_counter()
        times["background" if bg else "foreground"].append(1e3 * (t1 - t0))
        if bg:
            times["background_flush"].append(1e3 * (t2 - t0))
        shutil.rmtree(os.path.join(tmp, f"save_{i}"), ignore_errors=True)
    n = sum(v.numel() for v in tr.params.values())
    return dict(parameters=n, **{f"{k}_ms": v for k, v in times.items()},
                **{f"{k}_ms_median": statistics.median(v)
                   for k, v in times.items()})


def _newest_state(save_dir):
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_checkpoint)
    path = latest_checkpoint(save_dir)
    return os.path.basename(path), load_checkpoint(path)


def _same_bits(a, b):
    """The keys of two checkpoints' (params, opt, state) that differ."""
    diff = []
    for x, y in zip(a, b):
        if set(x) != set(y):
            return ["key sets"]
        diff += [k for k in x if not np.array_equal(x[k], y[k])]
    return diff


def _training_resume(tmp, conf):
    """(d): the dropout classifier, --save_dir D --saving_period_by_batches
    2 --background_save, RESUME_PASSES passes: twice without a kill (the
    same bits), then killed by an ``exit`` fault at step RESUME_KILL_AT
    (a process of its own: ``os._exit``) and run again without the plan:
    the final checkpoint bit-equal to the runs without the kill (every
    key: parameters, slots, counters, the step generator). The runs
    without a kill and the resumed one run in this process."""
    from paddle_tpu_torch.testing.chaos import FaultPlan
    args = ["--config", conf, "--job", "train", "--num_passes",
            str(RESUME_PASSES), "--seed", str(SEED),
            "--saving_period_by_batches", str(RESUME_CADENCE),
            "--background_save"]
    env = dict(os.environ)
    env.pop("PADDLE_TPU_CHAOS_PLAN", None)
    clean = []
    for i in range(2):
        save_dir = os.path.join(tmp, f"resume_clean{i}")
        out = _cli_inproc(args + ["--save_dir", save_dir])
        clean.append((save_dir, _pass_costs(out), _summary(out)))
    states = [_newest_state(d) for d, _, _ in clean]
    diff = _same_bits(states[0][1], states[1][1])
    if diff:
        raise AssertionError(f"two runs without a kill differ in {diff}")
    kill_dir = os.path.join(tmp, "resume_kill")
    plan = FaultPlan(faults=[{"type": "kill", "site": "step_done",
                              "at": RESUME_KILL_AT, "mode": "exit"}])
    killed = _cli_run(args + ["--save_dir", kill_dir],
                      env=dict(env, PADDLE_TPU_CHAOS_PLAN=plan.to_json()),
                      expect=plan.exit_code)
    saved = sorted(n for n in os.listdir(kill_dir) if n.endswith(".npz"))
    out = _cli_inproc(args + ["--save_dir", kill_dir])
    resumed = _newest_state(kill_dir)
    diff = _same_bits(states[0][1], resumed[1])
    if diff or resumed[0] != states[0][0]:
        raise AssertionError(f"the resumed run's {resumed[0]} differs from "
                             f"{states[0][0]} in {diff}")
    summary = _summary(out)
    return dict(passes=RESUME_PASSES, cadence=RESUME_CADENCE,
                kill_at=RESUME_KILL_AT, saved_at_kill=saved,
                killed_passes=_pass_costs(killed),
                resumed_steps=summary["steps"],
                resumed_pass_costs=_pass_costs(out),
                clean_pass_costs=clean[0][1],
                final_checkpoint=states[0][0],
                keys=sum(len(x) for x in states[0][1]), bit_equal=True,
                two_clean_runs_bit_equal=True,
                save_ms=clean[0][2]["save_ms"],
                median_step_ms=clean[0][2]["median_step_ms"],
                kernels=clean[0][2]["kernels"])


def _training_dropout(conf):
    """(e): the keep mask on the card at the dropout layer's shape
    (TRAIN_BATCH x hidden): the keep fraction within 4 sigma of the
    binomial mean, the same bits from one seed twice, another layer's
    stream another mask; the gradient through the layer the mask times the
    upstream gradient; the dropout classifier's cost over DROP_PASSES
    passes of --job train falling."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core import network
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       str(DROP_PASSES), "--seed", str(SEED)])
    costs, summary = _pass_costs(out), _summary(out)
    shape = (TRAIN_BATCH, MODEL["hidden"])
    ctx = network.Context(train=True, seed=SEED)
    a = network._dropout_mask(shape, DROP_RATE, ctx, "drop", "cuda")
    b = network._dropout_mask(shape, DROP_RATE, ctx, "drop", "cuda")
    other = network._dropout_mask(shape, DROP_RATE, ctx, "other", "cuda")
    n = a.numel()
    kept = float(a.sum())
    sigma = (n * DROP_RATE * (1 - DROP_RATE)) ** 0.5
    dsl.reset()
    x = dsl.data(name="x", size=MODEL["hidden"])
    d = dsl.dropout(x, DROP_RATE, name="drop")
    net = network.Network(dsl.current_graph(), outputs=[d.name])
    xv = torch.randn(*shape, device="cuda", requires_grad=True)
    up = torch.randn(*shape, device="cuda")
    y = net.apply({}, {"x": Argument(xv)}, train=True, seed=SEED)["drop"]
    (gx,) = torch.autograd.grad((y.value * up).sum(), [xv])
    ok = dict(
        keep_within_4_sigma=abs(kept - n * (1 - DROP_RATE)) <= 4 * sigma,
        same_bits=bool(torch.equal(a, b)),
        layers_differ=not bool(torch.equal(a, other)),
        grad_is_mask_times_upstream=bool(torch.equal(gx, a * up)),
        costs_fall=bool(all(np.isfinite(costs)) and costs[-1] < costs[0]))
    if not all(ok.values()):
        raise AssertionError(f"dropout on the card: {ok}")
    return dict(shape=list(shape), rate=DROP_RATE, kept=kept,
                expected=n * (1 - DROP_RATE), sigma=sigma, pass_costs=costs,
                median_step_ms=summary["median_step_ms"],
                kernels=summary["kernels"], **ok)


def _printed_floats(out, tag):
    lines = [ln for ln in out.splitlines() if not ln.startswith(
        ("Test:", "test_summary", "Pass"))]
    return [float(v) for ln in lines for v in ln.replace(",", " ").split()
            if v.replace(".", "", 1).replace("-", "", 1).replace(
                "e", "", 1).isdigit()]


def _training_evaluators(tmp, save_dir):
    """(f): --job test of the dropout classifier's checkpoint (d) with
    classification_error, auc, precision_recall and pnpair declared and
    three printers, on the card and on the CPU plain path (both in this
    process): every evaluator value within 1e-6, the
    printers' lines printed, their numbers within 1e-5 of the CPU's."""
    conf = os.path.join(tmp, "eval_conf.py")
    _write_dropout_config(conf, evaluators=True)
    args = ["--config", conf, "--job", "test", "--save_dir", save_dir]
    card = _cli_inproc(args)
    cpu = _cli_inproc(args + ["--device", "cpu"])

    def values(out):
        line = next(ln for ln in out.splitlines() if ln.startswith("Test:"))
        return {kv.split("=")[0]: float(kv.split("=")[1])
                for kv in line[len("Test: "):].split()}

    vc, vp = values(card), values(cpu)
    errs = {k: abs(vc[k] - vp[k]) for k in vp}
    if set(vc) != set(vp) or max(errs.values()) > 1e-6 \
            or not {"err", "auc", "pr", "pnpair"} <= set(vc):
        raise AssertionError(f"evaluators card {vc}, CPU {vp}")
    pc, pp = _printed_floats(card, ""), _printed_floats(cpu, "")
    heads = ("row max id vector", "Classification Error", "value:")
    if len(pc) != len(pp) or not all(h in card for h in heads):
        raise AssertionError("the printers' lines differ in shape")
    print_err = max(abs(a - b) for a, b in zip(pc, pp))
    if print_err > 1e-5:
        raise AssertionError(f"printed numbers differ by {print_err}")
    return dict(card=vc, cpu=vp, max_abs_err=max(errs.values()),
                printed_numbers=len(pc), printed_max_abs_err=print_err,
                test_kernels=_summary(card, "test_summary")["kernels"])


_CHECKGRAD_CONF = """
import numpy as np
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.data.types import integer_value, integer_value_sequence
from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
cost, out, _ = lstm_text_classifier(vocab_size=50, embed_dim=32, hidden=32,
                                    num_layers=2, classes=2)
feeding = DataFeeder({"words": integer_value_sequence(50),
                      "label": integer_value(2)}, pad_multiple=16)

def train_reader():
    rng = np.random.default_rng(3)
    batch = []
    for n in rng.integers(1, 17, size=8):
        ids = rng.integers(0, 50, size=int(n))
        batch.append((ids.tolist(), int((ids < 25).mean() > 0.5)))
    yield batch
"""


def _training_jobs(tmp, conf):
    """(g): --job time of the main config on the card (its step times),
    --job checkgrad of a small LSTM classifier on the card (autograd
    through the LSTM kernels against float64 central differences)."""
    out = _cli_inproc(["--config", conf, "--job", "time", "--time_batches",
                       "5", "--time_warmup", "2", "--seed", str(SEED)])
    timing = _summary(out, "time_summary")
    if len(timing["step_ms"]) != 5 \
            or timing["kernels"]["lstm_seq_train"]["launches"] <= 0:
        raise AssertionError(f"--job time: {out[-2000:]}")
    small = os.path.join(tmp, "checkgrad_conf.py")
    with open(small, "w") as f:
        f.write(_CHECKGRAD_CONF)
    from paddle_tpu_torch import ops
    ops.reset_kernel_counts()
    line = _cli_inproc(["--config", small, "--job",
                        "checkgrad"]).strip().splitlines()[-1]
    launched = ops.kernel_counts()["lstm_seq_train"]["launches"]
    if "PASSED" not in line or launched <= 0:
        raise AssertionError(f"--job checkgrad: {line}, {launched} "
                             "lstm_seq_train launches")
    return dict(time=timing, checkgrad=line,
                checkgrad_lstm_seq_train_launches=launched)


def check_training(tmp, adam_k1_costs=None):
    """Phase 13, the rest of training: (a) to (g) at the classifier's
    full width. ``adam_k1_costs``: the Adam config's pass costs at k = 1
    (phase 8's run), recorded beside its k = 2 run's. Returns the row, its
    ``launches`` the CLI runs' kernel counts summed."""
    t0 = time.perf_counter()
    conf = os.path.join(tmp, "training_conf.py")
    _write_config(conf, "optimizer = Adam(learning_rate=2e-3)")
    mom_conf = os.path.join(tmp, "training_momentum_conf.py")
    _write_config(mom_conf, "# no optimizer: the CLI's default Momentum")
    drop_conf = os.path.join(tmp, "dropout_conf.py")
    _write_dropout_config(drop_conf)
    row, seconds = {}, {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t1
        return out

    row["accum"] = part("accum", _training_accum, conf, mom_conf)
    row["accum"]["adam_pass_costs_k1"] = adam_k1_costs
    row["prev_batch_state"] = part("prev_batch_state", _training_carry)
    row["async"] = part("async", _training_async)
    row["save_times"] = part("save_times", _training_save_times, tmp)
    row["resume"] = part("resume", _training_resume, tmp, drop_conf)
    row["dropout"] = part("dropout", _training_dropout, drop_conf)
    row["evaluators"] = part("evaluators", _training_evaluators, tmp,
                             os.path.join(tmp, "resume_clean0"))
    row["jobs"] = part("jobs", _training_jobs, tmp, conf)
    launches = {}
    for counts in (row["accum"]["kernels"], row["accum"]["adam_kernels"],
                   row["resume"]["kernels"], row["dropout"]["kernels"],
                   row["evaluators"]["test_kernels"]):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c["launches"]
    row.update(launches=launches, part_seconds=seconds,
               seconds=time.perf_counter() - t0)
    phase("training", seconds=row["seconds"], part_seconds=seconds,
          launches={k: v for k, v in launches.items() if v},
          accum={k: row["accum"][k] for k in (
              "routes", "k2", "k4", "pass_costs_k1", "pass_costs_k2",
              "pass_cost_rel_err", "median_step_ms_k1", "median_step_ms_k2",
              "adam_pass_costs_k1", "adam_pass_costs_k2",
              "adam_median_step_ms_k2")},
          carry={k: row["prev_batch_state"][k] for k in (
              "cost_rel_err", "carried_max_abs_err", "h0_max_abs")},
          async_wall_ms={m: (row["async"][f"{m}_wall_ms_median"],
                             row["async"][f"{m}_wall_ms_spread"])
                         for m in ("sync", "async")},
          save_ms={k: row["save_times"][f"{k}_ms_median"] for k in (
              "foreground", "background", "background_flush")},
          resume={k: row["resume"][k] for k in (
              "saved_at_kill", "final_checkpoint", "keys", "bit_equal",
              "clean_pass_costs")},
          evaluators={k: row["evaluators"][k] for k in (
              "card", "max_abs_err", "printed_max_abs_err")},
          time_median_step_ms=row["jobs"]["time"]["median_step_ms"],
          checkgrad=row["jobs"]["checkgrad"])
    return row


def training():
    """``--training``: phase 13 alone; its row in ``training.json`` in
    ``OUT_DIR``."""
    build.build_all(["lstm_seq", "opt_update"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        out = check_training(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "training.json"), "w") as f:
        json.dump(out, f, indent=1)


# ------------------------------------------------------ 14. the layer plane

_DS2R_SAMPLES = """
def spectrogram(frames):
    # frequency rows, time columns (flat f * {W} + t), padded with the
    # silence prototype to {W} columns
    pad = np.repeat(PROTOS[{V}][None], {W} - len(frames), axis=0)
    return np.concatenate([frames, pad]).T.reshape(-1).astype(np.float32)


def released(batch):
    return [(spectrogram(f), chars) for f, chars in batch]
""".format(W=DS2_MAX_T, V=DS2["chars"])


def _ds2r_ns(use_gru):
    """The config's namespace and the port's DSL, with the model built
    (``ns["build"]()`` builds it again after a reset)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config import model_config as mc
    ns = {"np": np}
    exec(_DS2_SAMPLES + _DS2R_SAMPLES + _DS2R_MODEL, ns)
    ns["build"] = lambda: ns["deep_speech2"](dsl, mc, use_gru=use_gru,
                                             **DS2R)
    dsl.reset()
    return ns


def _ds2r_feeder(device):
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (dense_vector,
                                             integer_value_sequence)
    return DataFeeder({"audio": dense_vector(DS2R["height"] * DS2_MAX_T),
                       "text": integer_value_sequence(DS2["chars"])},
                      length_buckets=[DS2_LABEL_PAD], device=device)


def _write_ds2r_config(path, use_gru):
    head = textwrap.dedent("""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.config import model_config as mc
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import (dense_vector,
                                                     integer_value_sequence)
            from paddle_tpu_torch.optim import Adam
        """)
    tail = textwrap.dedent(f"""

            dsl.reset()
            cost, probs = deep_speech2(dsl, mc, use_gru={use_gru},
                                       **{DS2R!r})
            optimizer = Adam(learning_rate={DS2_LR})
            # transcripts pad to {DS2_LABEL_PAD} characters
            feeding = DataFeeder(
                {{"audio": dense_vector({DS2R['height'] * DS2_MAX_T}),
                  "text": integer_value_sequence({DS2['chars']})}},
                length_buckets=[{DS2_LABEL_PAD}])

            def train_reader():
                rng = np.random.default_rng({SEED})
                for _ in range({DS2_BATCHES}):
                    yield released(utterances(rng, {DS2_BATCH}))

            def test_reader():
                rng = np.random.default_rng({SEED + 2})
                for _ in range({DS2R_TEST_BATCHES}):
                    yield released(utterances(rng, {DS2_BATCH}))
        """)
    with open(path, "w") as f:
        f.write(head + _DS2_SAMPLES + _DS2R_SAMPLES + _DS2R_MODEL + tail)


@contextlib.contextmanager
def _kink_masks(record=None, replay=None):
    """The executor's and the recurrences' relu and brelu (all reached
    through ``apply_activation``) with their masks recorded (appended to
    ``record`` in call order: the activation, x > 0 and, for brelu, x >=
    24) or replayed (``replay``: an earlier run's, out = x * live + 24 *
    top, whose gradient is the live mask). A replay must use up every
    mask."""
    from paddle_tpu_torch.layers import activations
    plain = activations.apply_activation
    left = iter(replay or ())

    def act(kind, value, mask=None):
        if kind not in ("relu", "brelu"):
            return plain(kind, value, mask)
        if replay is None:
            if record is not None:
                v = value.detach()
                top = v >= 24.0 if kind == "brelu" else None
                live = (v > 0) if top is None else (v > 0) & ~top
                record.append((kind, live.cpu(), None if top is None
                               else top.cpu()))
            return plain(kind, value, mask)
        rkind, live, top = next(left)
        if rkind != kind:
            raise AssertionError(f"replayed {rkind} mask at a {kind}")
        out = value * live.to(value.device, value.dtype)
        if top is not None:
            out = out + 24.0 * top.to(value.device, value.dtype)
        return out

    activations.apply_activation = act
    try:
        yield
    finally:
        activations.apply_activation = plain
    if replay is not None and next(left, None) is not None:
        raise AssertionError("a recorded activation mask was not used")


def _ds2r_grads(build, save_dir, feed):
    """One batch's loss and every gradient from the newest checkpoint of
    ``save_dir``, card against the CPU, per tensor within 1e-3 of the
    CPU's largest entry + 1e-6 (the loss within 1e-5 relative): ``route``
    "direct". Where float32 puts a pre-activation within rounding of a
    relu or brelu kink, the card and the CPU may take different sides and
    route a whole entry elsewhere; then the CPU runs in float64, the exact
    reference, recording its masks, and both run again in float32 with
    those masks replayed and must hold each other and the float64
    gradients within the same tolerance (``route`` "masks"). The card runs
    in float32 only: the CTC kernels take float32."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = build()[0]
    params, _ = load_params(latest_checkpoint(save_dir))
    runs, masks, seconds = {}, [], {}

    def run(key, device, dtype, **kink):
        t0 = time.perf_counter()
        tr = SGD(cost, parameters=params, device=device,
                 update_equation=Adam(learning_rate=DS2_LR))
        tr.params = {k: v.to(dtype) for k, v in tr.params.items()}
        dfeed = tr._to_device(feed)
        for arg in dfeed.values():
            if arg.value.is_floating_point():
                arg.value = arg.value.to(dtype)
        with _kink_masks(**kink):
            _, loss, grads, _ = tr.loss_and_grads(dfeed)
        runs[key] = (float(loss), {k: g.cpu().double()
                                   for k, g in grads.items()})
        seconds[key] = time.perf_counter() - t0

    run("cuda", "cuda", torch.float32)
    run("cpu", "cpu", torch.float32)
    limit = {k: 1e-3 * g.abs().max().item() + 1e-6
             for k, g in runs["cpu"][1].items()}

    def multiple(key, against):
        """The largest distance of ``key``'s gradients from ``against``'s,
        per tensor, as a multiple of the tolerance."""
        return max((runs[key][1][k] - w).abs().max().item() / limit[k]
                   for k, w in runs[against][1].items())

    if not abs(runs["cuda"][0] - runs["cpu"][0]) <= 1e-5 * abs(
            runs["cpu"][0]):
        raise AssertionError(f"DS2 loss {runs['cuda'][0]} on the card, "
                             f"{runs['cpu'][0]} on the CPU")
    row = dict(loss_cuda=runs["cuda"][0], loss_cpu=runs["cpu"][0],
               limit_multiple=dict(cuda_vs_cpu=multiple("cuda", "cpu")),
               grad_max_abs_err=max(
                   (runs["cuda"][1][k] - w).abs().max().item()
                   for k, w in runs["cpu"][1].items()),
               tensors=len(limit))
    if row["limit_multiple"]["cuda_vs_cpu"] <= 1.0:
        row["route"] = "direct"
    else:
        row["route"] = "masks"
        run("cpu64", "cpu", torch.float64, record=masks)
        run("cuda_m", "cuda", torch.float32, replay=masks)
        run("cpu_m", "cpu", torch.float32, replay=masks)
        row.update(loss_cpu64=runs["cpu64"][0], masks=len(masks))
        row["limit_multiple"].update(
            cuda_vs_64=multiple("cuda", "cpu64"),
            cpu_vs_64=multiple("cpu", "cpu64"),
            cuda_m_vs_cpu_m=multiple("cuda_m", "cpu_m"),
            cuda_m_vs_64=multiple("cuda_m", "cpu64"),
            cpu_m_vs_64=multiple("cpu_m", "cpu64"))
        for what in ("cuda_m_vs_cpu_m", "cuda_m_vs_64", "cpu_m_vs_64"):
            if not row["limit_multiple"][what] <= 1.0:
                raise AssertionError(f"DS2 gradients {what}: "
                                     f"{row['limit_multiple']}")
    row["seconds"] = seconds
    return row


def _ds2r_train(tmp, use_gru, passes):
    """--job train of one branch in this process (4 batches of 16, Adam):
    (save_dir, pass lines, pass costs, train_summary)."""
    name = "gru" if use_gru else "simple_rnn"
    conf = os.path.join(tmp, f"ds2r_{name}_conf.py")
    _write_ds2r_config(conf, use_gru)
    save_dir = os.path.join(tmp, f"ds2r_{name}_ckpt")
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       str(passes), "--seed", str(SEED), "--save_dir",
                       save_dir])
    passes_out = [ln for ln in out.splitlines() if ln.startswith("Pass ")]
    costs = _pass_costs(out)
    summary = _summary(out)
    if len(costs) != passes or summary["steps"] != passes * DS2_BATCHES:
        raise AssertionError(f"DS2 {name} train printed {passes_out}, "
                             f"{summary}")
    if not all(np.isfinite(costs)):
        raise AssertionError(f"DS2 {name} pass costs {costs}")
    return conf, save_dir, passes_out, costs, summary


def _ds2r_test(conf, save_dir):
    """--job test (cost, ctc_edit_distance) on the card and on the CPU
    plain path: the cost within 1e-4 relative; the edit distance within
    one character of the test set's transcripts, since a best-path frame
    whose top two scores lie within rounding may decode otherwise."""
    got, seconds = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                           save_dir, "--device", device])
        seconds[device] = time.perf_counter() - t0
        line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
        got[device] = ({k: float(v) for k, v in (kv.split("=") for kv in
                                                 line[6:].split())},
                       _summary(out, "test_summary")["kernels"])
    (card, counts), (cpu, _) = got["cuda"], got["cpu"]
    ns = _ds2r_ns(True)
    rng = np.random.default_rng(SEED + 2)
    chars = sum(len(c) for _ in range(DS2R_TEST_BATCHES)
                for _, c in ns["utterances"](rng, DS2_BATCH))
    if set(card) != {"cost", "ctc_edit_distance"} or not all(
            np.isfinite(list(card.values()))):
        raise AssertionError(f"DS2 --job test printed {card}")
    if not abs(card["cost"] - cpu["cost"]) <= 1e-4 * abs(cpu["cost"]):
        raise AssertionError(f"DS2 test cost {card} on the card, {cpu} on "
                             "the CPU")
    if not abs(card["ctc_edit_distance"] - cpu["ctc_edit_distance"]) <= \
            1.0 / chars:
        raise AssertionError(f"DS2 test error {card} on the card, {cpu} on "
                             "the CPU")
    if counts["ctc_fused_fwd"]["launches"] <= 0 or \
            counts["ctc_fused_bwd"]["launches"] != 0:
        raise AssertionError(f"DS2 --job test launches {counts}")
    return dict(card=card, cpu=cpu, transcript_chars=chars,
                kernels={k: v for k, v in counts.items()
                         if v["launches"]}, seconds=seconds)


def _ds2r_check_probs(build, save_dir, feed):
    """The release's probability output (softmax of the mixed layer over
    the scores) on the card: finite, rows summing to 1, within rtol 1e-4
    / atol 1e-5 of the CPU's."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    dsl.reset()
    probs = build()[1]
    net = Network(probs.graph, outputs=[probs.name])
    params, _ = load_params(latest_checkpoint(save_dir))
    outs = {}
    for device in ("cuda", "cpu"):
        p = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
        f = {k: Argument(value=a.value.to(device), mask=None if a.mask is None
                         else a.mask.to(device)) for k, a in feed.items()}
        with torch.no_grad():
            outs[device] = net.apply(p, f)[probs.name].value.cpu()
    got, want = outs["cuda"], outs["cpu"]
    if tuple(got.shape) != (feed["audio"].value.shape[0], DS2R_STEPS,
                            DS2["chars"] + 1):
        raise AssertionError(f"DS2 probs shape {tuple(got.shape)}")
    if not torch.isfinite(got).all() or not torch.allclose(
            got.sum(-1), torch.ones(()), atol=1e-5):
        raise AssertionError("DS2 probs are not distributions")
    return dict(shape=list(got.shape),
                max_abs_err=_close("DS2 probs", got, want))


def check_ds2_release(tmp):
    """(a) and (b) of phase 14; the row keeps the GRU branch's kernel
    counts (``kernels``, its --job train) for the kernels line."""
    from paddle_tpu_torch.optim import Adam
    t0 = time.perf_counter()
    seconds = {}
    conf, save_dir, lines, costs, summary = _ds2r_train(tmp, True,
                                                        DS2R_PASSES)
    seconds["gru_train"] = time.perf_counter() - t0
    counts = summary["kernels"]
    if not costs[-1] < costs[0]:
        raise AssertionError(f"DS2 pass costs {costs} do not fall")
    steps = summary["steps"]
    if (counts["ctc_fused_fwd"]["launches"], counts["ctc_fused_bwd"][
            "launches"]) != (steps, steps):
        raise AssertionError(f"DS2 train CTC launches {counts}")
    _check_opt_launches("DS2 --job train", counts, steps)
    # relu is no default activation: the GRUs take their inline step in
    # both packages, no GRU kernel
    for name in ("gru_seq_train", "gru_bwd_chain", "gru_bwd_step", "gru_seq",
                 "gru_cell"):
        if counts[name]["launches"]:
            raise AssertionError(f"DS2 train launched {name}")
    ns = _ds2r_ns(True)
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    n_params = sum(int(np.asarray(v).size) for v in
                   load_params(latest_checkpoint(save_dir))[0].values())
    batch = ns["utterances"](np.random.default_rng(SEED + 1), DS2_GRAD_ROWS)
    batch[1] = (batch[1][0], [])  # an empty transcript
    feed = _ds2r_feeder("cpu")(ns["released"](batch))
    t1 = time.perf_counter()
    grads = _ds2r_grads(ns["build"], save_dir, feed)
    probs = _ds2r_check_probs(ns["build"], save_dir, feed)
    seconds["gru_grads"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    trace = _step_trace(ns["build"], save_dir, Adam(learning_rate=DS2_LR),
                        _ds2r_feeder("cpu")(ns["released"](ns["utterances"](
                            np.random.default_rng(SEED), DS2_BATCH))),
                        cpu_ops=False)
    seconds["gru_trace"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    test = _ds2r_test(conf, save_dir)
    seconds["gru_test"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rconf, rdir, rlines, rcosts, rsummary = _ds2r_train(tmp, False,
                                                        DS2R_RNN_PASSES)
    rns = _ds2r_ns(False)
    rgrads = _ds2r_grads(rns["build"], rdir, feed)
    seconds["simple_rnn"] = time.perf_counter() - t1
    gru = dict(parameters=n_params, pass_lines=lines, pass_costs=costs,
               steps=steps, median_step_ms=summary["median_step_ms"],
               step_ms=summary["step_ms"], grad_check=grads, probs=probs,
               step_trace=trace, test=test)
    rnn = dict(pass_lines=rlines, pass_costs=rcosts,
               steps=rsummary["steps"],
               median_step_ms=rsummary["median_step_ms"],
               grad_check=rgrads)
    phase("ds2_release_gru", **{k: v for k, v in gru.items()
                                if k != "step_ms"})
    phase("ds2_release_simple_rnn", **rnn)
    return dict(gru=gru, simple_rnn=rnn, kernels=counts, seconds=seconds)


def _case(data, name, type_, inputs, feed, **kw):
    """One layer case: (data layers [(name, size, kwargs)], the layer's
    keywords, feed {name: (value, mask)})."""
    return data, dict(name=name, type=type_, inputs=inputs,
                      size=kw.pop("size", None), act=kw.pop("act", "linear"),
                      bias=kw.pop("bias", False), attrs=kw), feed


def _m_rng(seed):
    return np.random.RandomState(seed)


def _m_dense(b=3, d=6, seed=0, positive=False):
    v = _m_rng(seed).randn(b, d).astype(np.float32)
    return (np.abs(v) + 0.5 if positive else v), None


def _m_seq(b=3, t=5, d=6, seed=0, full=False):
    r = _m_rng(seed)
    mask = np.ones((b, t), np.float32)
    if not full:
        for i, n in enumerate(r.randint(2, t + 1, size=b)):
            mask[i, n:] = 0.0
    v = r.randn(b, t, d).astype(np.float32) * mask[..., None]
    return v, mask


def _m_seq_ids(b=3, t=5, classes=4, seed=2):
    ids = _m_rng(seed).randint(0, classes, size=(b, t)).astype(np.int32)
    return ids, np.ones((b, t), np.float32)


def _m_img(b=2, c=2, h=6, w=6, seed=0):
    return _m_rng(seed).randn(b, h, w, c).astype(np.float32), None


def _m_softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _m_sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(np.float32)


def layer_cases():
    """Every layer type of the layer plane, and the last types that have
    a matrix row, at the shapes and with the inputs of the tier-1 matrix (``tests/test_layer_grad_matrix.py``'s
    ``_case_*``; ``tests/test_torch_layer_matrix.py`` holds this table
    equal to them): type -> (data layers, layer keywords, feed)."""
    from paddle_tpu_torch.config.model_config import Input, ParamAttr
    D = _m_dense
    img4 = {"channels": 2, "height": 4, "width": 4}
    img6 = {"channels": 2, "height": 6, "width": 6}
    sel = np.zeros((3, 4), np.float32)
    sel[:, :2] = 1.0
    rel = _m_rng(1).rand(3, 5, 1).astype(np.float32)
    lam_s = _m_seq(d=1, t=5, seed=0)
    return {
        "concat2": _case([("a", 6, {}), ("b", 4, {})], "out", "concat2",
                         ["a", "b"], {"a": D(), "b": D(d=4, seed=1)},
                         size=8, act="tanh",
                         projections=[{"type": "full_matrix", "size": 4},
                                      {"type": "identity", "size": 4}]),
        "mixed": _case([("a", 6, {}), ("b", 4, {})], "out", "mixed",
                       ["a", "b"], {"a": D(), "b": D(d=4, seed=1)}, size=4,
                       act="tanh", projections=[{"type": "full_matrix"},
                                                {"type": "dot_mul"}]),
        "recurrent": _case([("x", 6, {"is_sequence": True})], "out",
                           "recurrent", ["x"], {"x": _m_seq()}, bias=True,
                           active_type="tanh"),
        "mdlstmemory": _case(
            [("x", 4 * 4 * 10, {"channels": 10, "height": 4, "width": 4,
                                "is_sequence": False})], "out", "mdlstmemory",
            [Input("x", extra={"channels": 10})],
            {"x": (_m_rng(3).randn(2, 4, 4, 10).astype(np.float32), None)},
            size=2, bias=True),
        "seqreshape": _case([("x", 6, {"is_sequence": True})], "out",
                            "seqreshape", ["x"], {"x": _m_seq(full=True)},
                            size=3),
        "seqconcat": _case([("a", 6, {"is_sequence": True}),
                            ("b", 6, {"is_sequence": True})], "out",
                           "seqconcat", ["a", "b"],
                           {"a": _m_seq(), "b": _m_seq(seed=1)}),
        "featmap_expand": _case([("x", 6, {})], "out", "featmap_expand",
                                ["x"], {"x": D()}, num_filters=3),
        "interpolation": _case(
            [("w", 1, {}), ("a", 6, {}), ("b", 6, {})], "out",
            "interpolation", ["w", "a", "b"],
            {"w": (_m_rng(2).rand(3, 1).astype(np.float32), None),
             "a": D(), "b": D(seed=1)}),
        "power": _case([("w", 1, {}), ("x", 6, {})], "out", "power",
                       ["w", "x"], {"w": (np.full((3, 1), 2.0, np.float32),
                                          None), "x": D(positive=True)}),
        "slope_intercept": _case([("x", 6, {})], "out", "slope_intercept",
                                 ["x"], {"x": D()}, slope=2.0,
                                 intercept=1.0),
        "clip": _case([("x", 6, {})], "out", "clip", ["x"], {"x": D()},
                      min=-0.5, max=0.5),
        "sum_to_one_norm": _case([("x", 6, {})], "out", "sum_to_one_norm",
                                 ["x"], {"x": D(positive=True)}),
        "row_l2_norm": _case([("x", 6, {})], "out", "row_l2_norm", ["x"],
                             {"x": D()}),
        "cos": _case([("a", 6, {}), ("b", 6, {})], "out", "cos", ["a", "b"],
                     {"a": D(), "b": D(seed=1)}, cos_scale=1.0),
        "cos_vm": _case([("a", 4, {}), ("b", 12, {})], "out", "cos_vm",
                        ["a", "b"], {"a": D(d=4), "b": D(d=12, seed=1)},
                        size=3, cos_scale=1.0),
        "convex_comb": _case([("w", 3, {}), ("v", 12, {})], "out",
                             "convex_comb", ["w", "v"],
                             {"w": D(d=3), "v": D(d=12, seed=1)}, size=4),
        "trans": _case([("x", 6, {})], "out", "trans", ["x"],
                       {"x": D(b=6, d=6)}),
        "rotate": _case([("x", 32, img4)], "out", "rotate", ["x"],
                        {"x": _m_img(c=2, h=4, w=4)}),
        "resize": _case([("x", 6, {})], "out", "resize", ["x"],
                        {"x": D(b=2, d=6)}, size=3),
        "pad": _case([("x", 32, img4)], "out", "pad", ["x"],
                     {"x": _m_img(c=2, h=4, w=4)}, pad_c=[1, 1],
                     pad_h=[0, 1], pad_w=[1, 0]),
        "crop": _case([("x", 32, img4)], "out", "crop", ["x"],
                      {"x": _m_img(c=2, h=4, w=4)}, axis=2, offset=[1, 1],
                      shape=[2, 2]),
        "maxout": _case([("x", 72, img6)], "out", "maxout", ["x"],
                        {"x": _m_img()}, groups=2),
        "blockexpand": _case([("x", 32, img4)], "out", "blockexpand", ["x"],
                             {"x": _m_img(c=2, h=4, w=4)}, block_x=2,
                             block_y=2, stride_x=2, stride_y=2, channels=2),
        "bilinear_interp": _case([("x", 32, img4)], "out",
                                 "bilinear_interp", ["x"],
                                 {"x": _m_img(c=2, h=4, w=4)}, out_size_x=8,
                                 out_size_y=8),
        "row_conv": _case([("x", 6, {"is_sequence": True})], "out",
                          "row_conv", ["x"], {"x": _m_seq()},
                          context_length=2),
        "conv_shift": _case([("a", 7, {}), ("b", 3, {})], "out",
                            "conv_shift", ["a", "b"],
                            {"a": D(d=7), "b": D(d=3, seed=1)}),
        "tensor": _case([("a", 4, {}), ("b", 5, {})], "out", "tensor",
                        ["a", "b"], {"a": D(d=4), "b": D(d=5, seed=1)},
                        size=3, bias=True),
        "selective_fc": _case([("x", 6, {}), ("sel", 4, {})], "out",
                              "selective_fc", ["x", "sel"],
                              {"x": D(), "sel": (sel, None)}, size=4,
                              bias=True, active_type="tanh"),
        "prelu": _case([("x", 6, {})], "out", "prelu", ["x"], {"x": D()}),
        "agent": _case([("x", 6, {})], "out", "agent", ["x"], {"x": D()}),
        "scatter_agent": _case([("x", 6, {})], "out", "scatter_agent",
                               ["x"], {"x": D()}),
        "gather_agent": _case([("x", 6, {"is_sequence": True}),
                               ("y", 6, {"is_sequence": True})], "out",
                              "gather_agent", ["x", "y"],
                              {"x": _m_seq(), "y": _m_seq(seed=3)}),
        "out_prod": _case([("x", 3, {}), ("y", 4, {})], "out", "out_prod",
                          ["x", "y"], {"x": D(d=3), "y": D(d=4, seed=5)}),
        "data_norm": _case(
            [("x", 6, {})], "out", "data_norm",
            [Input("x", param_attr=ParamAttr(init="normal", initial_mean=0.1,
                                             initial_std=0.5))],
            {"x": D()}, data_norm_strategy="z-score"),
        "multi_class_cross_entropy_with_selfnorm": _case(
            [("p", 4, {}), ("y", 4, {})], "out",
            "multi_class_cross_entropy_with_selfnorm", ["p", "y"],
            {"p": D(d=4, positive=True),
             "y": (_m_rng(1).randint(0, 4, size=3).astype(np.int32), None)},
            softmax_selfnorm_alpha=0.1),
        "soft_binary_class_cross_entropy": _case(
            [("p", 4, {}), ("y", 4, {})], "out",
            "soft_binary_class_cross_entropy", ["p", "y"],
            {"p": (_m_sigmoid(_m_rng(0).randn(3, 4)), None),
             "y": (_m_rng(1).rand(3, 4).astype(np.float32), None)}),
        "multi_binary_label_cross_entropy": _case(
            [("p", 4, {}), ("y", 4, {})], "out",
            "multi_binary_label_cross_entropy", ["p", "y"],
            {"p": (_m_sigmoid(_m_rng(0).randn(3, 4)), None),
             "y": ((_m_rng(1).rand(3, 4) > 0.5).astype(np.float32), None)}),
        "square_error": _case([("p", 4, {}), ("y", 4, {})], "out",
                              "square_error", ["p", "y"],
                              {"p": D(d=4), "y": D(d=4, seed=1)}),
        "smooth_l1": _case([("p", 4, {}), ("y", 4, {})], "out", "smooth_l1",
                           ["p", "y"], {"p": D(d=4), "y": D(d=4, seed=1)}),
        "huber_classification": _case(
            [("p", 1, {}), ("y", 1, {})], "out", "huber_classification",
            ["p", "y"], {"p": D(d=1), "y": (_m_rng(1).randint(
                0, 2, size=3).astype(np.int32), None)}),
        "rank-cost": _case(
            [("l", 1, {}), ("r", 1, {}), ("y", 1, {})], "out", "rank-cost",
            ["l", "r", "y"], {"l": D(d=1), "r": D(d=1, seed=1),
                              "y": (_m_rng(2).randint(0, 2, size=(3, 1))
                                    .astype(np.float32), None)}),
        "lambda_cost": _case(
            [("s", 1, {"is_sequence": True}), ("y", 1, {"is_sequence": True})],
            "out", "lambda_cost", ["s", "y"],
            {"s": lam_s, "y": (rel, lam_s[1])}, NDCG_num=3),
        "sum_cost": _case([("x", 4, {})], "out", "sum_cost", ["x"],
                          {"x": D(d=4)}),
        "kl_gaussian": _case([("mu", 4, {}), ("lv", 4, {})], "out",
                             "kl_gaussian", ["mu", "lv"],
                             {"mu": D(d=4), "lv": D(d=4, seed=1)}),
        # forward-only: integer or random outputs
        "maxid": _case([("x", 6, {})], "out", "maxid", ["x"], {"x": D()}),
        "eos_id": _case([("x", 1, {"is_sequence": True})], "out", "eos_id",
                        ["x"], {"x": _m_seq_ids(classes=3)}, eos_id=1),
        "sampling_id": _case([("x", 4, {})], "out", "sampling_id", ["x"],
                             {"x": (_m_softmax(_m_rng(0).randn(3, 4)),
                                    None)}),
        "kmax_seq_score": _case([("x", 1, {"is_sequence": True})], "out",
                                "kmax_seq_score", ["x"],
                                {"x": _m_seq(d=1)}, beam_size=2),
        "multiplex": _case([("i", 1, {}), ("a", 6, {}), ("b", 6, {})], "out",
                           "multiplex", ["i", "a", "b"],
                           {"i": (np.array([0, 1, 0], np.int32), None),
                            "a": D(), "b": D(seed=1)}),
        "print": _case([("x", 4, {})], "out", "print", ["x"],
                       {"x": D(d=4)}),
        # the last types with a matrix row (phase 15 checks the rest);
        # at evaluation nce takes its strided negatives and
        # sample_gaussian gives mu
        "subseq": _case(
            [("x", 5, {"is_sequence": True}), ("off", 1, {}), ("n", 1, {})],
            "out", "subseq", ["x", "off", "n"],
            {"x": _m_seq(b=3, t=6, d=5, full=True),
             "off": (np.array([0, 1, 2], np.int32), None),
             "n": (np.array([3, 2, 4], np.int32), None)}),
        "nce": _case([("x", 6, {}), ("y", 8, {})], "out", "nce", ["x", "y"],
                     {"x": D(), "y": (_m_rng(1).randint(0, 8, size=3)
                                      .astype(np.int32), None)},
                     bias=True, num_classes=8, num_neg_samples=4),
        "hsigmoid": _case([("x", 6, {}), ("y", 8, {})], "out", "hsigmoid",
                          ["x", "y"],
                          {"x": D(), "y": (_m_rng(1).randint(0, 8, size=3)
                                           .astype(np.int32), None)},
                          bias=True, num_classes=8),
        "sample_gaussian": _case([("mu", 4, {}), ("lv", 4, {})], "out",
                                 "sample_gaussian", ["mu", "lv"],
                                 {"mu": D(d=4), "lv": D(d=4, seed=1)}),
        "priorbox": _case(
            [("x", 32, {"channels": 2, "height": 4, "width": 4}),
             ("img", 48, {"channels": 3, "height": 4, "width": 4})],
            "out", "priorbox", ["x", "img"],
            {"x": _m_img(c=2, h=4, w=4), "img": _m_img(c=3, h=4, w=4)},
            min_size=[2], max_size=[], aspect_ratio=[1.0],
            variance=[0.1] * 4),
    }


def layer_case_net(case):
    """The port's network of one ``layer_cases`` entry, with parameters
    from the seed by name (a moving variance positive), as numpy."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.model_config import Input, LayerDef
    from paddle_tpu_torch.core.network import Network
    data, kw, _ = case
    dsl.reset()
    for name, size, dkw in data:
        dsl.data(name=name, size=size, **dkw)
    kw = dict(kw, inputs=[i if isinstance(i, Input) else Input(i)
                          for i in kw["inputs"]])
    dsl.current_graph().add(LayerDef(**kw))
    net = Network(dsl.current_graph(), outputs=[kw["name"]])
    rng = np.random.default_rng(11)
    params = {}
    for k, s in sorted(net.param_specs.items()):
        p = (rng.normal(size=s.shape) * 0.5).astype(np.float32)
        params[k] = np.abs(p) + 0.5 if k.endswith(".w2") else p
    return net, params


def _layer_run(net, name, params, feed, device, w=None):
    """(output, {leaf: gradient}) of layer ``name`` on ``device``; with
    ``w``, the gradients of sum(out * w) for every trained parameter and
    float input."""
    tp = {k: torch.from_numpy(v).to(device).requires_grad_(
        w is not None and not net.param_specs[k].is_static)
        for k, v in params.items()}
    tx = {k: torch.from_numpy(v).to(device).requires_grad_(
        w is not None and np.issubdtype(v.dtype, np.floating))
        for k, (v, _) in feed.items()}
    f = {k: Argument(value=tx[k], mask=None if m is None
                     else torch.from_numpy(m).to(device))
         for k, (_, m) in feed.items()}
    out = net.apply(tp, f, seed=SEED)[name].value
    if w is None:
        return out.detach().cpu(), {}
    leaves = {k: t for k, t in {**tp, **tx}.items() if t.requires_grad}
    if not leaves or not out.requires_grad:
        # a float output of integer inputs (eos_id) or of none of them
        # (priorbox: the geometry alone)
        return out.detach().cpu(), {}
    grads = torch.autograd.grad((out * torch.from_numpy(w).to(device)).sum(),
                                list(leaves.values()), allow_unused=True)
    return out.detach().cpu(), {
        k: (torch.zeros_like(t) if g is None else g).cpu()
        for (k, t), g in zip(leaves.items(), grads)}


def _sampling_on_card():
    """sampling_id on the card three ways: one-hot rows draw their id;
    each id's frequency over 20,000 draws of (0.1, 0.2, 0.3, 0.4) within
    0.015 of its probability; the same seed the same bits, another seed
    another draw."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    dsl.reset()
    dsl.sampling_id_layer(input=dsl.data(name="x", size=4), name="ids")
    net = Network(dsl.current_graph(), outputs=["ids"])

    def draw(p, seed):
        x = Argument(value=torch.from_numpy(p).cuda())
        return net.apply({}, {"x": x}, seed=seed)["ids"].value.cpu().numpy()
    ids = np.array([3, 0, 2, 1, 3])
    for seed in range(3):
        if not np.array_equal(draw(np.eye(4, dtype=np.float32)[ids], seed),
                              ids):
            raise AssertionError("sampling_id: a one-hot row drew another "
                                 "id on the card")
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    p = np.tile(probs, (20000, 1))
    a = draw(p, 7)
    freq = np.bincount(a, minlength=4) / a.size
    if not np.all(np.abs(freq - probs) <= 0.015):
        raise AssertionError(f"sampling_id frequencies {freq} on the card")
    if not np.array_equal(draw(p, 7), a) or np.array_equal(draw(p, 8), a):
        raise AssertionError("sampling_id: the card's draw does not repeat "
                             "under its seed")
    return dict(frequencies=freq.tolist())


def check_layer_matrix():
    """(c): every layer type this slice ports, forward and gradient, on
    the card against the CPU at the tier-1 matrix's shapes: values within
    rtol 1e-4 / atol 1e-5, each gradient within 1e-4 of its largest entry
    + 1e-5; integer outputs equal; sampling_id three ways; print passes
    its input through."""
    t0 = time.perf_counter()
    rows = {}
    for type_, case in sorted(layer_cases().items()):
        if type_ == "sampling_id":
            rows[type_] = _sampling_on_card()
            continue
        net, params = layer_case_net(case)
        name, feed = case[1]["name"], case[2]
        cpu, _ = _layer_run(net, name, params, feed, "cpu")
        grad = cpu.is_floating_point() and type_ != "print"
        w = (np.random.default_rng(5).normal(size=tuple(cpu.shape))
             .astype(np.float32) if grad else None)
        cpu, gcpu = _layer_run(net, name, params, feed, "cpu", w)
        card, gcard = _layer_run(net, name, params, feed, "cuda", w)
        if tuple(card.shape) != tuple(cpu.shape) or card.dtype != cpu.dtype:
            raise AssertionError(f"{type_}: {card.shape} {card.dtype} on "
                                 f"the card, {cpu.shape} {cpu.dtype}")
        if grad:
            err = _close(f"layer {type_}", card, cpu)
        elif not torch.equal(card, cpu):
            raise AssertionError(f"layer {type_}: the card's output differs")
        else:
            err = 0.0
        gerr = 0.0
        for k, g in gcpu.items():
            e = (gcard[k] - g).abs().max().item()
            if not e <= 1e-4 * g.abs().max().item() + 1e-5:
                raise AssertionError(f"layer {type_} d/d {k}: max abs err "
                                     f"{e}")
            gerr = max(gerr, e)
        rows[type_] = dict(max_abs_err=err, grad_max_abs_err=gerr,
                           grads=len(gcpu))
    row = dict(types=len(rows), rows=rows,
               seconds=time.perf_counter() - t0)
    phase("layer_matrix", types=len(rows), seconds=row["seconds"],
          max_abs_err=max(r.get("max_abs_err", 0) for r in rows.values()),
          grad_max_abs_err=max(r.get("grad_max_abs_err", 0)
                               for r in rows.values()))
    return row


def _ds2r_ctc_row(ctc_rows):
    """Phase 6b's row at DeepSpeech2 as released's (16, 134, S = 133)."""
    return next(r for r in ctc_rows
                if (r["B"], r["T"]) == (DS2_BATCH, DS2R_STEPS))


def check_layers(tmp, ctc):
    """Phase 14, the layer plane: (a) and (b) DeepSpeech2 as released,
    (c) the layer matrix on the card; ``ctc``: the CTC kernels' check at
    its (16, 134, S <= 133), phase 6b's row."""
    t0 = time.perf_counter()
    ds2 = check_ds2_release(tmp)
    matrix = check_layer_matrix()
    row = dict(ds2_release=ds2, ctc_shape=ctc, layer_matrix=matrix,
               seconds=time.perf_counter() - t0)
    phase("layers", seconds=row["seconds"], ds2_seconds=ds2["seconds"],
          ctc_shape={k: ctc[k] for k in ("B", "T", "S")},
          ctc_fused_fwd_max_abs_err=ctc["fused_fwd_max_abs_err"],
          ctc_fused_bwd_max_abs_err=ctc["fused_bwd_max_abs_err"])
    return row


def layers():
    """``--layers``: phase 14 alone (the CTC shape checked first, as phase
    6b would); its row in ``layers.json`` in ``OUT_DIR``."""
    build.build_all(SOURCES)
    floors = {(P, beta): _chain_floor_us(P, beta)
              for P in (1, 2, 4) for beta in (False, True)}
    ctc = check_ctc_shape(DS2_BATCH, DS2R_STEPS, DS2_LABEL_PAD,
                          DS2_BATCH + DS2R_STEPS, floors)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        out = check_layers(tmp, ctc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "layers.json"), "w") as f:
        json.dump(out, f, indent=1)


# ------------------------------------------------ 15. the last layer types
# (a) the nested GRU text model at seq2seq's widths (PERF.md §4)
NEST = dict(vocab_size=30000, embed_dim=512, hidden=512, classes=3)
NEST_BATCH, NEST_SENTS, NEST_WORDS = 50, (2, 8), (5, 30)
# (b) the PaddlePaddle book's N-gram word2vec: 4 context words, embedding
# 32, hidden 256, the imikolov synthetic tier's 2048 words
W2V = dict(vocab_size=2048, embed_dim=32, hidden=256, context=4)
W2V_BATCH = 256
# (c) SSD300 (Liu et al. 2016; Caffe ssd_pascal.py): (map, channels),
# min and max sizes, aspect ratios; 21 VOC classes
SSD_IMAGE = 300
SSD_MAPS = [(38, 512), (19, 1024), (10, 512), (5, 256), (3, 256), (1, 256)]
SSD_MIN = [30, 60, 111, 162, 213, 264]
SSD_MAX = [60, 111, 162, 213, 264, 315]
SSD_AR = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]
SSD_PRIORS = 8732
SSD_CLASSES, SSD_BATCH, SSD_GT = 21, 32, (1, 8)
SSD_DET = dict(confidence_threshold=0.01, nms_threshold=0.45, nms_top_k=400,
               keep_top_k=200)
SSD_STEPS = 4
# (d) the VAE as models/vae.py builds it (v1_api_demo/vae)
VAE_DIMS = dict(data_dim=784, hidden=256, latent=32)
VAE_BATCH = 64
# (e) moe: d 512, hidden 2048, 8 experts over 50 x 64 tokens
MOE = dict(d=512, hidden=2048, experts=8, rows=50, T=64, tight=128)
LT_BATCHES, LT_PASSES = 4, 3
# two detections whose scores lie within the score tolerance of each
# other may take each other's rank on the card and on the CPU
LT_TIE_ATOL = 1e-5


def _lt_sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _grad_share(where, got, want, rel=1e-3, floor=1e-6):
    """Each gradient within ``rel`` of its largest entry + ``floor``; the
    largest share of that tolerance an entry takes."""
    share = 0.0
    for k, g in want.items():
        err = (got[k].cpu().double() - g.cpu().double()).abs().max().item()
        lim = rel * g.abs().max().item() + floor
        if not err <= lim:
            raise AssertionError(f"{where} d/d {k}: max abs err {err} > "
                                 f"{lim}")
        share = max(share, err / lim)
    return share


def _lt_loss_grads(cost, params, feed, device, seed=None):
    """(outputs, loss, {param: gradient on the CPU}) of one batch from
    ``params`` on ``device`` through ``SGD.loss_and_grads``."""
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.trainer import SGD
    tr = SGD(cost, parameters=params, device=device, update_equation=Adam())
    outs, loss, grads, _ = tr.loss_and_grads(tr._to_device(feed), seed=seed)
    _lt_sync()
    return outs, float(loss), {k: v.detach().cpu() for k, v in grads.items()}


def _lt_card_vs_cpu(where, cost, params, feed, dev, seed=None):
    """One batch's loss and gradients on the card against the CPU: the
    loss within rtol 1e-4, each gradient within 1e-3 of its largest entry
    + 1e-6 (PERF.md §2, full-width training)."""
    _, loss_cpu, g_cpu = _lt_loss_grads(cost, params, feed, "cpu", seed)
    _, loss_dev, g_dev = _lt_loss_grads(cost, params, feed, dev, seed)
    if not abs(loss_dev - loss_cpu) <= 1e-4 * abs(loss_cpu) + 1e-5:
        raise AssertionError(f"{where}: loss {loss_dev} on the card, "
                             f"{loss_cpu} on the CPU")
    return dict(loss=loss_dev, loss_cpu=loss_cpu,
                grad_share=_grad_share(where, g_dev, g_cpu))


@contextlib.contextmanager
def _cpu_draws():
    """nce's negatives and sample_gaussian's eps drawn by the CPU's
    generator whatever the device, so the card replays the CPU's draws
    (``layers/sampling.py``'s helpers, the one switch)."""
    from paddle_tpu_torch.layers import sampling
    negs, eps = sampling._nce_negatives, sampling._gaussian_eps
    sampling._nce_negatives = (lambda shape, n, ctx, name, device: negs(
        shape, n, ctx, name, "cpu").to(device))
    sampling._gaussian_eps = (lambda shape, dtype, ctx, name, device: eps(
        shape, dtype, ctx, name, "cpu").to(device))
    try:
        yield
    finally:
        sampling._nce_negatives, sampling._gaussian_eps = negs, eps


def _lt_train(cost, batches, optimizer, dev, passes=LT_PASSES):
    """``SGD.train`` over ``batches`` (feeds) for ``passes`` passes on
    ``dev``, the kernel counts set to 0 just before it and read just
    after: (trainer, each pass's mean cost, the launches by kernel)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.trainer import events
    from paddle_tpu_torch.trainer.trainer import SGD
    tr = SGD(cost, device=dev, seed=SEED, update_equation=optimizer)
    costs = {}
    ops.reset_kernel_counts()
    tr.train(lambda: iter(batches), num_passes=passes,
             event_handler=lambda e: costs.setdefault(e.pass_id, []).append(
                 e.cost) if isinstance(e, events.EndIteration) else None)
    _lt_sync()
    launches = {k: c["launches"] for k, c in ops.kernel_counts().items()
                if c.get("launches")}
    pass_costs = [float(np.mean(costs[p])) for p in sorted(costs)]
    if not all(np.isfinite(pass_costs)) or not pass_costs[-1] < pass_costs[0]:
        raise AssertionError(f"the cost did not fall: {pass_costs}")
    return tr, pass_costs, launches


def _lt_step(tr, feed):
    """One more training step's host ms (median of 3 after a warm one)
    and, from a step traced for its device activity alone, the busy ms
    and the idle share (None off the card)."""
    feed = tr._to_device(feed)

    def step():
        t0 = time.perf_counter()
        tr.train_step(feed)
        _lt_sync()
        return 1e3 * (time.perf_counter() - t0)
    step()
    row = dict(step_ms=statistics.median(step() for _ in range(3)))
    row.update(_lt_busy(step))
    return row


def _lt_busy(fn):
    """Device busy ms of one call of ``fn`` (traced for its CUDA activity
    alone; ``fn`` returns its wall ms), its idle share and top kernels."""
    if not torch.cuda.is_available():
        return dict(device_busy_ms=None, device_idle_share=None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = fn()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")]
    busy = 1e-3 * sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return dict(profiled_ms=wall, device_busy_ms=busy,
                device_idle_share=1 - busy / wall if busy else None,
                launches=sum(e.count for e in kernels),
                top_kernels=[dict(name=e.key[:60],
                                  ms=1e-3 * e.self_device_time_total,
                                  count=e.count) for e in top])


def _outs_grads(net, names, params, feed, device, seed=None):
    """The outputs ``names`` of ``net``'s training forward on ``device``
    (the differentiable kernels: ``gru_step``'s no-grad forward has no
    backward) and the gradients of sum_i sum(out_i * w_i) (fixed random
    w_i) for every parameter and float input; ``feed``: {name: (value,
    mask)} as numpy."""
    tp = {k: torch.as_tensor(np.asarray(v)).to(device).requires_grad_(
        not net.param_specs[k].is_static) for k, v in params.items()}
    tx = {k: torch.from_numpy(v).to(device).requires_grad_(
        np.issubdtype(v.dtype, np.floating)) for k, (v, _) in feed.items()}
    f = {k: Argument(value=tx[k], mask=None if m is None
                     else torch.from_numpy(m).to(device))
         for k, (_, m) in feed.items()}
    outs = net.apply(tp, f, train=True, seed=seed)
    rng = np.random.default_rng(5)
    total = 0.0
    for n in names:
        w = rng.normal(size=tuple(outs[n].value.shape)).astype(np.float32)
        total = total + (outs[n].value * torch.from_numpy(w).to(
            device)).sum()
    leaves = {k: t for k, t in {**tp, **tx}.items() if t.requires_grad}
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return ({n: outs[n].value.detach().cpu() for n in names},
            {k: (torch.zeros_like(t) if g is None else g).detach().cpu()
             for (k, t), g in zip(leaves.items(), grads)})


# (a) ------------------------------------------------- nested GRU text
def nested_text(dsl, nested=True, outlink=False):
    """``sequence_nest_rnn.conf``'s topology at seq2seq's widths: the
    words' embedding, an outer group over sentences whose inner group
    over words boots from the outer memory (a 3H projection and
    ``gru_step``), the outer memory the inner group's last output, then
    the document's last state and a softmax over the classes. ``nested=
    False``: the flat twin, one group over the concatenated words.
    ``outlink``: the outer step returns its whole inner output as well (a
    nested out-link); returns the group's (main, extra) handles."""
    H = NEST["hidden"]
    words = dsl.data(name="words", size=NEST["vocab_size"], is_sequence=True)
    label = dsl.data(name="label", size=NEST["classes"])
    emb = dsl.embedding(words, size=NEST["embed_dim"], name="emb")

    def word_step(w, boot=None):
        h = dsl.memory(name="h", size=H, boot_layer=boot)
        x = dsl.fc(input=w, size=3 * H, act="linear", name="proj")
        return dsl.gru_step_layer(x, h, name="h")

    if not nested:
        g = dsl.recurrent_group(word_step, emb, name="word_rnn")
    else:
        def sentence_step(sent):
            s = dsl.memory(name="sent", size=H)
            ws = dsl.recurrent_group(lambda w: word_step(w, s), sent,
                                     name="word_rnn")
            last = dsl.last_seq(ws, name="sent")
            return (ws, last) if outlink else last
        g = dsl.recurrent_group(sentence_step, dsl.SubsequenceInput(emb),
                                name="doc_rnn")
    if outlink:
        return g
    out = dsl.fc(input=dsl.last_seq(g, name="doc"), size=NEST["classes"],
                 act="softmax", name="out")
    return dsl.classification_cost(input=out, label=label, name="cost"), g


def _nest_docs(rng, n):
    """Synthetic documents of 2-8 sentences of 5-30 words; class c draws
    half its words from its own band of 300 ids."""
    docs = []
    for _ in range(n):
        c = int(rng.integers(0, NEST["classes"]))
        sents = []
        for _ in range(int(rng.integers(NEST_SENTS[0], NEST_SENTS[1] + 1))):
            k = int(rng.integers(NEST_WORDS[0], NEST_WORDS[1] + 1))
            band = rng.integers(c * 300, (c + 1) * 300, size=k)
            any_ = rng.integers(0, NEST["vocab_size"], size=k)
            sents.append(np.where(rng.random(k) < 0.5, band, any_).tolist())
        docs.append((sents, c))
    return docs


def _nest_feeders(dev):
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence,
                                             integer_value_sub_sequence)
    V, C = NEST["vocab_size"], NEST["classes"]
    return (DataFeeder({"words": integer_value_sub_sequence(V),
                        "label": integer_value(C)}, device=dev),
            DataFeeder({"words": integer_value_sequence(V),
                        "label": integer_value(C)}, device=dev))


def _np_feed(feed):
    return {k: (a.value.cpu().numpy(), None if a.mask is None
                else a.mask.cpu().numpy()) for k, a in feed.items()}


def check_nested_text(dev="cuda"):
    """15a: (i) nested == flat on the card (the document state and each
    sentence's state, forward at rtol 1e-4 / atol 1e-5); (ii) card
    against CPU, the loss and every gradient; (iii) 4 batches x 3 passes
    of Adam(5e-4): the cost falls, the step's ms, busy ms, idle share and
    the GRU cell's launches; then subseq, max and seqlastins over
    sentences on the outer group's nested out-link, card against CPU."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.model_config import Input, LayerDef
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.optim import Adam
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    docs = [_nest_docs(rng, NEST_BATCH) for _ in range(LT_BATCHES)]
    nfeed, ffeed = _nest_feeders(dev)
    dsl.reset()
    cost, _ = nested_text(dsl)
    net = Network(dsl.current_graph(), outputs=["doc", "doc_rnn", "cost"])
    params = net.init_params(torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    dsl.reset()
    nested_text(dsl, nested=False)
    flat_net = Network(dsl.current_graph(), outputs=["doc", "word_rnn"])
    assert set(flat_net.param_specs) <= set(net.param_specs)
    batch = docs[0]
    nf = nfeed([(d, c) for d, c in batch])
    ff = ffeed([(sum(d, []), c) for d, c in batch])
    with torch.no_grad():
        on = net.apply(params, nf)
        of = flat_net.apply(params, ff)
    flat_err = _close("15a nested == flat (doc)", on["doc"].value,
                      of["doc"].value)
    ends = []
    for b, (d, _) in enumerate(batch):
        t = -1
        for s, sent in enumerate(d):
            t += len(sent)
            ends.append((b, s, t))
    bi, si, ti = (torch.tensor(x, device=dev) for x in zip(*ends))
    flat_err = max(flat_err, _close(
        "15a nested == flat (sentences)", on["doc_rnn"].value[bi, si],
        of["word_rnn"].value[bi, ti]))
    np_params = {k: v.cpu() for k, v in params.items()}
    vs_cpu = _lt_card_vs_cpu("15a", cost, np_params, nf, dev)
    tr, pass_costs, launches = _lt_train(
        cost, [nfeed([(d, c) for d, c in b]) for b in docs],
        Adam(learning_rate=5e-4), dev)
    step = _lt_step(tr, nf)
    # subseq and the TO_SEQUENCE layers on the nested out-link
    dsl.reset()
    ws, _ = nested_text(dsl, outlink=True)
    for name, type_ in (("sent_max", "max"), ("sent_last", "seqlastins")):
        dsl._add(LayerDef(name=name, type=type_, inputs=[Input(ws.name)],
                          bias=False, attrs={"trans_type": "seq"}))
    dsl.data(name="off", size=1)
    dsl.data(name="n", size=1)
    dsl._add(LayerDef(name="span", type="subseq",
                      inputs=[Input(ws.name), Input("off"), Input("n")],
                      bias=True))
    names = ["sent_max", "sent_last", "span"]
    onet = Network(dsl.current_graph(), outputs=names)
    oparams = {k: np_params[k] if k in np_params else torch.zeros(s.shape)
               for k, s in onet.param_specs.items()}
    feed = _np_feed(nf)
    tq = feed["words"][0].shape[-1]
    feed["off"] = (np.full(NEST_BATCH, tq, np.int32), None)
    feed["n"] = (np.full(NEST_BATCH, tq // 2, np.int32), None)
    cpu_o, cpu_g = _outs_grads(onet, names, oparams, feed, "cpu")
    dev_o, dev_g = _outs_grads(onet, names, oparams, feed, dev)
    out_err = max(_close(f"15a {n}", dev_o[n], cpu_o[n]) for n in names)
    out_share = _grad_share("15a nested out-link", dev_g, cpu_g)
    row = dict(batch=NEST_BATCH, max_sentences=int(nf["words"].mask.shape[1]),
               sentence_pad=int(tq), nested_vs_flat_max_abs_err=flat_err,
               card_vs_cpu=vs_cpu, pass_costs=pass_costs, launches=launches,
               step=step, outlink_max_abs_err=out_err,
               outlink_grad_share=out_share,
               seconds=time.perf_counter() - t0)
    phase("last_types_a", **{k: row[k] for k in (
        "nested_vs_flat_max_abs_err", "pass_costs", "launches",
        "outlink_max_abs_err", "outlink_grad_share", "seconds")},
          card_vs_cpu=vs_cpu, step=step)
    return row


# (b) ----------------------------------------------------- word2vec
def ngram_lm(dsl, cost_type="hsigmoid"):
    """The PaddlePaddle book's N-gram model: 4 context words through one
    shared embedding, concatenated, a sigmoid fc, then hsigmoid or nce
    (``num_neg_samples`` at the DSL's default) over the vocabulary."""
    V = W2V["vocab_size"]
    ctx = [dsl.embedding(dsl.data(name=f"w{i}", size=V), size=W2V[
        "embed_dim"], name=f"emb{i}", param_attr={"name": "_proj"})
        for i in range(W2V["context"])]
    nxt = dsl.data(name="next", size=V)
    hid = dsl.fc(input=dsl.concat(ctx, name="context"), size=W2V["hidden"],
                 act="sigmoid", name="hidden")
    if cost_type == "hsigmoid":
        return dsl.hsigmoid(hid, nxt, num_classes=V, name="cost")
    return dsl.nce_layer(hid, nxt, num_classes=V, name="cost")


def _w2v_batches(rng, dev):
    """5-grams whose next word is the last context word + 1 (7 in 10) or
    any word."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import integer_value
    V = W2V["vocab_size"]
    names = [f"w{i}" for i in range(W2V["context"])] + ["next"]
    feeder = DataFeeder({n: integer_value(V) for n in names}, device=dev)
    out = []
    for _ in range(LT_BATCHES):
        ctx = rng.integers(0, V, size=(W2V_BATCH, W2V["context"]))
        nxt = np.where(rng.random(W2V_BATCH) < 0.7, (ctx[:, -1] + 1) % V,
                       rng.integers(0, V, size=W2V_BATCH))
        out.append(feeder([tuple(int(v) for v in c) + (int(n),)
                           for c, n in zip(ctx, nxt)]))
    return out


def check_word2vec(dev="cuda"):
    """15b: hsigmoid and nce heads, each card against CPU (the loss and
    every gradient; nce's negatives the CPU's, replayed), then 4 batches
    x 3 passes of Adam(1e-3) with the card's own draws: the cost falls."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.optim import Adam
    t0 = time.perf_counter()
    batches = _w2v_batches(np.random.default_rng(SEED + 1), dev)
    rows = {}
    for kind in ("hsigmoid", "nce"):
        dsl.reset()
        cost = ngram_lm(dsl, kind)
        params = Network(dsl.current_graph(), outputs=[cost.name]).init_params(
            torch.Generator().manual_seed(SEED), device="cpu")
        with _cpu_draws():
            vs_cpu = _lt_card_vs_cpu(f"15b {kind}", cost, params,
                                     batches[0], dev, seed=SEED)
        _, pass_costs, launches = _lt_train(cost, batches,
                                            Adam(learning_rate=1e-3), dev)
        rows[kind] = dict(card_vs_cpu=vs_cpu, pass_costs=pass_costs,
                          launches=launches)
    row = dict(rows, batch=W2V_BATCH, seconds=time.perf_counter() - t0)
    phase("last_types_b", **row)
    return row


# (c) ------------------------------------------------- SSD300's head
def ssd300_head(dsl):
    """SSD300's detection head over its six feature maps: a 3 x 3 loc
    and conf conv on each, priorbox on each, the maps' boxes, locs and
    confs concatenated in map order, multibox_loss and detection_output
    over them. Returns (loss, detections)."""
    img = dsl.data(name="image", size=3 * SSD_IMAGE ** 2, channels=3,
                   height=SSD_IMAGE, width=SSD_IMAGE)
    gt = dsl.data(name="gt", size=5, is_sequence=True)
    locs, confs, pbs = [], [], []
    for i, ((fm, ch), mn, mx, ar) in enumerate(zip(SSD_MAPS, SSD_MIN,
                                                   SSD_MAX, SSD_AR)):
        feat = dsl.data(name=f"map{i}", size=ch * fm * fm, channels=ch,
                        height=fm, width=fm)
        k = 2 + 2 * len(ar)
        for heads, width, what in ((locs, 4, "loc"),
                                   (confs, SSD_CLASSES, "conf")):
            c = dsl.conv(feat, num_filters=width * k, filter_size=3,
                         padding=1, act="linear", name=f"{what}{i}")
            heads.append(dsl.resize_layer(c, size=fm * fm * width * k,
                                          name=f"{what}{i}_flat"))
        pb = dsl.priorbox_layer(feat, img, min_size=[mn], max_size=[mx],
                                aspect_ratio=ar,
                                variance=[0.1, 0.1, 0.2, 0.2],
                                name=f"prior{i}")
        pbs.append(dsl.resize_layer(pb, size=pb.size, name=f"prior{i}_row"))
    loc = dsl.concat(locs, name="loc")
    conf = dsl.concat(confs, name="conf")
    priors = dsl.resize_layer(dsl.concat(pbs, name="priors_row"), size=8,
                              name="priors")
    loss = dsl.multibox_loss_layer(priors, gt, conf, loc,
                                   num_classes=SSD_CLASSES,
                                   overlap_threshold=0.5, neg_pos_ratio=3.0,
                                   name="loss")
    det = dsl.detection_output_layer(priors, conf, loc,
                                     num_classes=SSD_CLASSES, name="det",
                                     **SSD_DET)
    return loss, det


def _ssd_feed(rng):
    """Random feature maps (NHWC), a blank image, 1-8 ground-truth boxes
    an image with classes 1-20."""
    feed = {"image": (np.zeros((SSD_BATCH, SSD_IMAGE, SSD_IMAGE, 3),
                               np.float32), None)}
    for i, (fm, ch) in enumerate(SSD_MAPS):
        feed[f"map{i}"] = (rng.normal(size=(SSD_BATCH, fm, fm, ch)).astype(
            np.float32), None)
    G = SSD_GT[1]
    gtv = np.zeros((SSD_BATCH, G, 5), np.float32)
    gtm = np.zeros((SSD_BATCH, G), np.float32)
    for b in range(SSD_BATCH):
        n = int(rng.integers(SSD_GT[0], G + 1))
        lo = rng.random((n, 2)) * 0.7
        gtv[b, :n, 0] = rng.integers(1, SSD_CLASSES, size=n)
        gtv[b, :n, 1:3] = lo
        gtv[b, :n, 3:5] = np.minimum(lo + 0.05 + rng.random((n, 2)) * 0.4, 1)
        gtm[b, :n] = 1.0
    feed["gt"] = (gtv, gtm)
    return feed


def _compare_detections(got, want):
    """Valid rows card against CPU: labels and validity equal, score and
    box within 1e-5. A row that differs where the card's and the CPU's
    scores at its rank lie within that tolerance (two detections at a
    float32 near-tie, ranked the other way) is counted; any other
    difference fails. (rows compared, near-tie rows, max abs err)."""
    got, want = got.cpu(), want.cpu()
    near, err = 0, 0.0
    for b in range(want.shape[0]):
        for r in range(want.shape[1]):
            g, w = got[b, r], want[b, r]
            if w[6] == 0 and g[6] == 0:
                continue
            if g[0] == w[0] and g[6] == w[6] and torch.allclose(
                    g[1:6], w[1:6], rtol=0, atol=1e-5):
                err = max(err, (g[1:6] - w[1:6]).abs().max().item())
                continue
            # a swap at a near-tie: the score at this rank is the same
            tie = abs(g[1] - w[1]).item() <= LT_TIE_ATOL
            if not tie:
                raise AssertionError(f"detection_output image {b} row {r}: "
                                     f"card {g.tolist()}, CPU {w.tolist()}")
            near += 1
    return int((want[..., 6] > 0).sum()), near, err


def check_ssd300(dev="cuda"):
    """15c: the priors bit-equal card and CPU (8732 of them); the loss and
    the heads' gradients at rtol 1e-4; detection_output's rows; 4 Momentum
    steps lower the loss; the forward's and detection_output's ms and
    device ms (CUDA events, median of 5; the profiler's busy time)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.optim import Momentum
    from paddle_tpu_torch.trainer.trainer import SGD
    t0 = time.perf_counter()
    feed = _ssd_feed(np.random.default_rng(SEED + 2))
    dsl.reset()
    loss, det = ssd300_head(dsl)
    net = Network(dsl.current_graph(), outputs=["priors", "loss", "det"])
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cpu")
    runs = {}
    for device in ("cpu", dev):
        p = {k: v.to(device) for k, v in params.items()}
        f = {k: Argument(value=torch.from_numpy(v).to(device),
                         mask=None if m is None
                         else torch.from_numpy(m).to(device))
             for k, (v, m) in feed.items()}
        t1 = time.perf_counter()
        with torch.no_grad():
            runs[device] = (net.apply(p, f), p, f)
        _lt_sync()
        runs[device] += (time.perf_counter() - t1,)
    (cpu, _, _, cpu_s), (card, p, f, _) = runs["cpu"], runs[dev]
    n_priors = card["priors"].value.shape[0]
    if n_priors != SSD_PRIORS or not torch.equal(
            card["priors"].value.cpu(), cpu["priors"].value):
        raise AssertionError(f"15c priors: {n_priors}, or not bit-equal")
    rows, near, det_err = _compare_detections(card["det"].value,
                                              cpu["det"].value)
    # the loss and the heads' gradients
    grads = {}
    for device in ("cpu", dev):
        tr = SGD(loss, parameters=params, device=device,
                 update_equation=Momentum(learning_rate=1e-2, momentum=0.9))
        _, l, g, _ = tr.loss_and_grads(tr._to_device(
            {k: Argument(value=torch.from_numpy(v), mask=None if m is None
                         else torch.from_numpy(m)) for k, (v, m)
             in feed.items()}))
        grads[device] = (float(l), {k: v.cpu() for k, v in g.items()})
    if not abs(grads[dev][0] - grads["cpu"][0]) <= 1e-4 * abs(
            grads["cpu"][0]):
        raise AssertionError(f"15c loss {grads[dev][0]} on the card, "
                             f"{grads['cpu'][0]} on the CPU")
    grad_share = _grad_share("15c", grads[dev][1], grads["cpu"][1],
                             rel=1e-4, floor=1e-5)
    # 4 Momentum steps of the heads on this batch
    tr = SGD(loss, parameters=params, device=dev,
             update_equation=Momentum(learning_rate=1e-2, momentum=0.9))
    dfeed = tr._to_device({k: Argument(
        value=torch.from_numpy(v), mask=None if m is None
        else torch.from_numpy(m)) for k, (v, m) in feed.items()})
    ops.reset_kernel_counts()
    losses = [float(tr.train_step(dfeed)["cost"])
              for _ in range(SSD_STEPS)]
    _lt_sync()
    launches = {k: c["launches"] for k, c in ops.kernel_counts().items()
                if c.get("launches")}
    if not losses[-1] < losses[0]:
        raise AssertionError(f"15c: the loss did not fall: {losses}")
    # the forward and detection_output alone

    def forward():
        with torch.no_grad():
            return net.apply(p, f)
    outs = forward()

    def detect():
        with torch.no_grad():
            return net.apply_layer("det", p, outs)

    def timed(fn):
        def call():
            t1 = time.perf_counter()
            fn()
            _lt_sync()
            return 1e3 * (time.perf_counter() - t1)
        return call
    fwd = dict(ms=_time_ms(forward, reps=5, warmup=1),
               **_lt_busy(timed(forward)))
    det_t = dict(ms=_time_ms(detect, reps=5, warmup=1),
                 **_lt_busy(timed(detect)))
    row = dict(priors=n_priors, batch=SSD_BATCH, rows=rows,
               near_tie_rows=near, det_max_abs_err=det_err,
               loss=grads[dev][0], loss_cpu=grads["cpu"][0],
               grad_share=grad_share, momentum_losses=losses,
               launches=launches, forward=fwd, detection_output=det_t,
               nms_share_of_forward=(det_t["device_busy_ms"]
                                     / fwd["device_busy_ms"]
                                     if fwd.get("device_busy_ms") else None),
               nms_share_of_forward_wall=det_t["ms"] / fwd["ms"],
               cpu_forward_s=cpu_s, seconds=time.perf_counter() - t0)
    phase("last_types_c", **{k: v for k, v in row.items()
                             if k not in ("forward", "detection_output")},
          forward_ms=fwd["ms"], forward_busy_ms=fwd.get("device_busy_ms"),
          det_ms=det_t["ms"], det_busy_ms=det_t.get("device_busy_ms"))
    return row


# (d) ------------------------------------------------------------ VAE
def _vae_batches(rng, dev):
    proto = (rng.random((10, VAE_DIMS["data_dim"])) > 0.5).astype(np.float32)
    out = []
    for _ in range(LT_BATCHES):
        x = proto[rng.integers(0, 10, size=VAE_BATCH)]
        flip = rng.random(x.shape) < 0.05
        out.append({"x": Argument(value=torch.from_numpy(
            np.where(flip, 1 - x, x).astype(np.float32)).to(dev))})
    return out


def check_vae(dev="cuda"):
    """15d: the VAE at 784 / 256 / 32 on 28 x 28 synthetic digits: card
    against CPU with the CPU's eps replayed (both costs, every gradient);
    4 x 3 Adam(1e-3) with the card's own draws, the summed cost falls; the
    decoder graph produces from z with the trained parameters by name."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.models import vae, vae_decoder
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.trainer import Topology
    t0 = time.perf_counter()
    batches = _vae_batches(np.random.default_rng(SEED + 3), dev)
    dsl.reset()
    costs, _, _ = vae(**VAE_DIMS)
    topo = Topology(costs)
    params = topo.network.init_params(torch.Generator().manual_seed(SEED),
                                      device="cpu")
    cpu_feed = {"x": Argument(value=batches[0]["x"].value.cpu())}
    with _cpu_draws():
        vs_cpu = _lt_card_vs_cpu("15d", topo, params, cpu_feed, dev,
                                 seed=SEED)
        outs = {}
        for device in ("cpu", dev):
            o, _, _ = _lt_loss_grads(topo, params, cpu_feed, device, SEED)
            outs[device] = o
    each = max(_close(f"15d {c.name}", outs[dev][c.name].value.detach()
                      .cpu(), outs["cpu"][c.name].value.detach())
               for c in costs)
    tr, pass_costs, launches = _lt_train(topo, batches,
                                         Adam(learning_rate=1e-3), dev)
    dsl.reset()
    out = vae_decoder(**VAE_DIMS)
    dec = Network(dsl.current_graph(), outputs=[out.name])
    if not set(dec.param_specs) <= set(tr.params):
        raise AssertionError("15d: the decoder's parameters are not the "
                             "trained ones")
    z = torch.randn(16, VAE_DIMS["latent"],
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        v = dec.apply(tr.params, {"z": Argument(value=z)})[out.name].value
    if not (tuple(v.shape) == (16, VAE_DIMS["data_dim"])
            and 0 <= v.min().item() and v.max().item() <= 1):
        raise AssertionError(f"15d decoder: {tuple(v.shape)}")
    row = dict(card_vs_cpu=vs_cpu, costs_max_abs_err=each,
               pass_costs=pass_costs, launches=launches, batch=VAE_BATCH,
               seconds=time.perf_counter() - t0)
    phase("last_types_d", **row)
    return row


# (e) ------------------------------------------------------------ moe
def check_moe(dev="cuda"):
    """15e: the moe layer over 50 x 64 tokens with padded rows, card
    against CPU at a capacity that drops tokens and at the default: the
    output within rtol 1e-4 / atol 1e-5, each gradient within 1e-4 of
    its largest entry + 1e-5."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    B, T, d = MOE["rows"], MOE["T"], MOE["d"]
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    x = (rng.normal(size=(B, T, d)) * mask[..., None]).astype(np.float32)
    rows = {}
    for cap in (MOE["tight"], None):
        dsl.reset()
        dsl.moe(input=dsl.data(name="x", size=d, is_sequence=True),
                expert_hidden=MOE["hidden"], num_experts=MOE["experts"],
                capacity=cap, name="mx")
        net = Network(dsl.current_graph(), outputs=["mx"])
        params = {k: (rng.normal(size=s.shape) * (
            s.shape[-2] ** -0.5 if len(s.shape) > 1 else 0.1)).astype(
                np.float32) for k, s in sorted(net.param_specs.items())}
        feed = {"x": (x, mask)}
        cpu_o, cpu_g = _outs_grads(net, ["mx"], params, feed, "cpu")
        dev_o, dev_g = _outs_grads(net, ["mx"], params, feed, dev)
        err = _close(f"15e capacity {cap}", dev_o["mx"], cpu_o["mx"])
        share = _grad_share(f"15e capacity {cap}", dev_g, cpu_g, rel=1e-4,
                            floor=1e-5)
        live = cpu_o["mx"].abs().sum(-1) > 0
        rows["default" if cap is None else str(cap)] = dict(
            max_abs_err=err, grad_share=share,
            live_tokens=int(mask.sum()), routed_tokens=int(live.sum()))
    if rows[str(MOE["tight"])]["routed_tokens"] >= int(mask.sum()):
        raise AssertionError("15e: the tight capacity dropped no token")
    row = dict(rows=rows, seconds=time.perf_counter() - t0)
    phase("last_types_e", **row)
    return row


def check_last_types(dev="cuda"):
    """Phase 15: the last layer types (nested sequences, the sampled and
    hierarchical costs, SSD's layers, moe) through four models and the
    moe layer on the card, each held against the CPU. Returns the row,
    with the phase's launches by kernel."""
    t0 = time.perf_counter()
    row = dict(nested=check_nested_text(dev), word2vec=check_word2vec(dev),
               ssd300=check_ssd300(dev), vae=check_vae(dev),
               moe=check_moe(dev))
    launches = {}
    for part in (row["nested"], row["word2vec"]["hsigmoid"],
                 row["word2vec"]["nce"], row["ssd300"], row["vae"]):
        for k, n in part["launches"].items():
            launches[k] = launches.get(k, 0) + n
    row.update(launches=launches, seconds=time.perf_counter() - t0)
    phase("last_types", launches=launches, seconds=row["seconds"],
          parts={k: row[k]["seconds"] for k in ("nested", "word2vec",
                                                 "ssd300", "vae", "moe")})
    return row


def _check_last_launches(row):
    for k in ("gru_cell", "adam", "momentum"):
        if row["launches"].get(k, 0) <= 0:
            raise AssertionError(f"phase 15 never launched {k}")


def last_types():
    """``--last-types``: phase 15 alone; its row in ``last_types.json`` in
    ``OUT_DIR``."""
    build.build_all(["gru_cell", "opt_update"])
    row = check_last_types()
    _check_last_launches(row)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "last_types.json"), "w") as f:
        json.dump(row, f, indent=1)


# ------------------------------------------------------ 16. the serving tier
SERVE16_SOURCES = 12       # (a)'s generate mix: lengths 1-50, concurrent
SERVE16_QGEN_SOURCES = 4   # (c)'s int8 generate mix
SERVE16_ROWS = 16          # (b)'s score rows: lengths 1-100
# one length bucket: seq2seq's encoded source pads to its bucket, and a
# decode session's lanes hold one shape
GEN_CONT_BUCKETS = [S2S_LEN]
QUANT_TIERS = ("fp32", "bf16", "int8")


def _healthz(port):
    status, h = _http(port, "GET", "/healthz")
    if status != 200:
        raise AssertionError(f"/healthz answered {status}: {h}")
    return h


def _metrics(port):
    status, m = _http(port, "GET", "/metrics?format=json")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}: {m}")
    return m


def _post_all(port, path, bodies, timeout=300):
    """POST every body to ``path`` at once, a thread each: [(status,
    answer, wall ms)] in order."""
    out = [None] * len(bodies)

    def one(i, body):
        t0 = time.perf_counter()
        status, answer = _http(port, "POST", path, body)
        out[i] = (status, answer, 1e3 * (time.perf_counter() - t0))

    threads = [threading.Thread(target=one, args=(i, b), daemon=True)
               for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError(f"{path}: requests unanswered after {timeout}s")
    return out


def _deltas(before, after, names):
    """The kernel counts' growth between two /healthz reads."""
    return {n: {k: after[n][k] - before[n][k] for k in after[n]}
            for n in names}


@contextlib.contextmanager
def _server_group(tmp, specs, refused=()):
    """Every ``--job serve`` process of ``specs`` ({name: command}) started
    at once, so their start-ups and warmups overlap (each one's standard
    error in ``tmp/<name>.stderr``). Yields ``{"ports", "ready_s",
    "exits"}`` once all are ready; a process named in ``refused`` must
    exit before it is ready instead (its code in ``exits`` then). On
    leaving, SIGTERM must drain every server to exit 0 (their codes in
    ``exits`` too)."""
    t0 = time.perf_counter()
    procs, logs = {}, []
    group = {"ports": {}, "ready_s": {}, "exits": {}}
    try:
        for name, cmd in specs.items():
            logs.append(open(os.path.join(tmp, f"{name}.stderr"), "w"))
            procs[name] = subprocess.Popen(cmd, cwd=ROOT,
                                           stdout=subprocess.PIPE,
                                           stderr=logs[-1], text=True)
        for name, proc in procs.items():
            try:
                port = _wait_ready(proc, timeout=600)
            except AssertionError:
                if name not in refused:
                    raise
                group["exits"][name] = proc.wait(timeout=30)
                continue
            if name in refused:
                raise AssertionError(f"{name} became ready")
            group["ports"][name] = port
            group["ready_s"][name] = time.perf_counter() - t0
        yield group
        for name in group["ports"]:
            procs[name].send_signal(signal.SIGTERM)
        for name in group["ports"]:
            group["exits"][name] = procs[name].wait(timeout=120)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for log in logs:
            log.close()
    bad = {n: rc for n, rc in group["exits"].items()
           if n not in refused and rc != 0}
    for name in bad:
        with open(os.path.join(tmp, f"{name}.stderr")) as f:
            sys.stderr.write(f.read()[-4000:])
    if bad:
        raise AssertionError(f"servers exited {bad} after SIGTERM")


def _log(tmp, name):
    with open(os.path.join(tmp, f"{name}.stderr")) as f:
        return f.read()


def _gen_mode(port, sources, name):
    """``/v1/generate`` on a server: every source and a request with a
    1-ms deadline sent at once. Returns the answers, their wall ms, the
    deadline request's error code, the kernel counts' and the metrics'
    growth."""
    bodies = ([{"sample": s} for s in sources]
              + [{"sample": sources[0], "deadline_ms": 1}])
    h0, m0 = _healthz(port), _metrics(port)
    sent = _post_all(port, "/v1/generate", bodies)
    h1, m1 = _healthz(port), _metrics(port)
    for status, body, _ in sent[:-1]:
        if status != 200:
            raise AssertionError(f"{name}: /v1/generate answered {status}: "
                                 f"{body}")
    status, late, _ = sent[-1]
    if status != 504 or late["error"]["code"] != "deadline_exceeded":
        raise AssertionError(f"{name}: the 1-ms deadline got {status}: "
                             f"{late}")
    ms = [t for _, _, t in sent[:-1]]
    counters = ("decode_chunks_total", "continuous_admissions_total",
                "decode_steps_total", "batches_total", "responses_total",
                "deadline_exceeded_total")
    return dict(
        answers=[body["sequences"] for _, body, _ in sent[:-1]], ms=ms,
        p50_ms=float(np.percentile(ms, 50)),
        p90_ms=float(np.percentile(ms, 90)),
        deadline_error=late["error"]["code"],
        kernels=_deltas(h0["kernels"], h1["kernels"],
                        ("gru_seq", "gru_cell_infer")),
        metrics={c: m1[c] - m0[c] for c in counters},
        lane_occupancy_mean=m1["lane_occupancy"]["mean"],
        quant=h1["quant"], model_version=h1["model_version"])


def _score_tier(port, rows, dt):
    """``/v1/score`` of ``rows`` in one call on a classifier server: the
    scores, the /healthz quant block and version, the call's ms, the
    batches it took and its ``lstm_seq`` launches."""
    h0, m0 = _healthz(port), _metrics(port)
    t0 = time.perf_counter()
    status, body = _http(port, "POST", "/v1/score", {"rows": rows})
    rows_ms = 1e3 * (time.perf_counter() - t0)
    h1, m1 = _healthz(port), _metrics(port)
    if status != 200:
        raise AssertionError(f"{dt}: /v1/score answered {status}: {body}")
    return dict(scores=np.asarray([r["outputs"]["output"]
                                   for r in body["results"]], np.float64),
                quant=h1["quant"], model_version=h1["model_version"],
                rows_ms=rows_ms,
                batches=m1["batches_total"] - m0["batches_total"],
                lstm_seq=_deltas(h0["kernels"], h1["kernels"],
                                 ("lstm_seq",))["lstm_seq"])


def _cpu_beams(model, feeding, sources):
    """The port's CPU plain path on ``model``: each source's beams alone
    (``_row_beams``), and the file's parameters as f32 arrays (an int8 or
    bf16 file's dequantized) for ``_rescore_cpu``."""
    from paddle_tpu_torch import quant as quant_lib
    from paddle_tpu_torch.serving import ServingPredictor
    from paddle_tpu_torch.trainer.merge_model import load_merged_ex
    ref = ServingPredictor.from_merged(
        model, feeding, batch_buckets=[1], length_buckets=GEN_CONT_BUCKETS,
        device="cpu")
    wants = []
    for s in sources:
        (tk, sc, ln), _ = ref.generate_rows([tuple(s)])
        wants.append(_row_beams(tk, sc, ln, 0))
    _, params, _, extras = load_merged_ex(model)
    if extras.get("quant"):
        params = quant_lib.dequantize_params(params, extras["quant"])
    return ref, wants, params


def _hold_beams(answers, sources, model, feeding, cpu, device, where):
    """Each answer against the port's CPU plain path on the same file
    (``cpu``: ``_cpu_beams``) by ``_compare_beams``' rule; a parting is
    traced on ``device`` in this process through the same file, at the
    batch sizes the server may have run the source in (its rows compute
    alone: 8, 4, 2 or 1 copies of it). Returns (worst relative score
    error, partings)."""
    from paddle_tpu_torch.serving import ServingPredictor
    ref, wants, params = cpu
    card = []

    def trace(s, got):
        if not card:
            card.append(ServingPredictor.from_merged(
                model, feeding, batch_buckets=_batch_buckets(GEN_MAX_BATCH),
                length_buckets=GEN_CONT_BUCKETS, device=device))
        for n in (GEN_MAX_BATCH, 4, 2, 1):
            traced = _search_trace(lambda **h: _predictor_generate(
                card[0], [s] * n, **h), 0)
            if [x["tokens"] for x in traced[0]] == [
                    x["tokens"] for x in got]:
                break
        return traced, _search_trace(lambda **h: _predictor_generate(
            ref, [s], **h), 0)

    worst, partings = 0.0, []
    for i, (s, got, want) in enumerate(zip(sources, answers, wants)):
        err, part = _compare_beams(
            got, want,
            lambda beams, src=s[0]: _rescore_cpu(_s2s_training, params, src,
                                                 beams),
            lambda s=s, got=got: trace(s, got), f"{where} answer {i}")
        worst = max(worst, err)
        if part is not None:
            partings.append(dict(answer=i, **part))
    _check_partings(partings, len(answers), where)
    return worst, partings


def _check_session_launches(where, mode):
    """The session's step over all W*K rows launches gru_cell_infer once:
    one device launch a step, chunks x the default chunk steps."""
    from paddle_tpu_torch.core.generation import DEFAULT_DECODE_CHUNK
    cell = mode["kernels"]["gru_cell_infer"]
    steps = mode["metrics"]["decode_chunks_total"] * DEFAULT_DECODE_CHUNK
    if cell["launches"] != steps or cell["step_launches"] != steps:
        raise AssertionError(f"{where}: {cell} gru_cell_infer launches in "
                             f"{steps} session steps, one a step expected")


def _param_memory(path, feeding, rows, device):
    """A predictor of ``path`` on ``device``: the bytes its parameters
    hold there, and the peak above that during one request of ``rows``
    (None off the card)."""
    from paddle_tpu_torch.serving import ServingPredictor
    if device != "cuda":
        return dict(resident_bytes=None, peak_over_resident_bytes=None)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    pred = ServingPredictor.from_merged(
        path, feeding, batch_buckets=[len(rows)],
        length_buckets=LENGTH_BUCKETS, device=device)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - m0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pred.predict_rows(rows)
    peak = torch.cuda.max_memory_allocated() - base
    out = dict(resident_bytes=resident, param_bytes=pred.param_bytes(),
               peak_over_resident_bytes=peak)
    del pred
    torch.cuda.empty_cache()
    return out


def _drifted_int8(tmp, int8_model, feeding, device):
    """A drifted int8 file: JAX's ``_drifted_int8`` (an int8 table times
    -3 after the golden references were recorded), each table in turn,
    then every scale times 100, until the gate, run in this process,
    refuses the file (the golden rows of a model near its decision
    boundary may not see a table's corruption). Returns (path, the
    corruption)."""
    from paddle_tpu_torch.serving import QuantGateError, ServingPredictor
    from paddle_tpu_torch.trainer.merge_model import (load_merged_ex,
                                                      merge_model)
    graph, params, outputs, extras = load_merged_ex(int8_model)
    tables = sorted(k for k, v in params.items() if v.dtype == np.int8)
    path = os.path.join(tmp, "drifted.int8.ptmodel")
    scaled = dict(extras["quant"], scales={
        k: v * np.float32(100.0) for k, v in extras["quant"]["scales"].items()})
    tries = [(f"{t} x -3", dict(params, **{t: np.clip(
        params[t].astype(np.int32) * -3, -127, 127).astype(np.int8)}),
        extras["quant"]) for t in tables]
    tries.append(("every scale x 100", params, scaled))
    for what, bad, quant in tries:
        merge_model(path, graph, bad, outputs=outputs, quant=quant,
                    golden=extras["golden"])
        pred = ServingPredictor.from_merged(
            path, feeding, batch_buckets=_batch_buckets(MAX_BATCH),
            length_buckets=LENGTH_BUCKETS, device=device)
        try:
            pred._run_quant_gate()
        except QuantGateError:
            return path, what
        finally:
            del pred
    raise AssertionError("no corruption of the int8 file moved the golden "
                         "outputs past the gate")


def _merge16(conf, save_dir, model, device, quantize=None):
    args = ["--config", conf, "--job", "merge", "--save_dir", save_dir,
            "--model_path", model, "--device", device]
    _cli_inproc(args + (["--quantize", quantize] if quantize else []))
    return model


def _continuous_holds(modes, sources, model, feeding, cpu, device):
    """(a)'s checks after the servers stopped: both modes against the CPU
    (``cpu``: ``_cpu_beams``, one reference for both), the modes apart only
    at near-ties, the session's launches."""
    cont, convoy = modes["continuous"], modes["convoy"]
    if cont["metrics"]["continuous_admissions_total"] <= 0:
        raise AssertionError("no request was admitted after the first "
                             f"chunk: {cont['metrics']}")
    if convoy["metrics"]["decode_chunks_total"] != 0:
        raise AssertionError("the convoy server ran a decode session")
    holds = {}
    for key, mode in modes.items():
        worst, partings = _hold_beams(mode["answers"], sources, model,
                                      feeding, cpu, device, key)
        holds[key] = dict(max_rel_score_err_vs_cpu=worst,
                          tie_flips=len(partings), partings=partings)
    parted = {p["answer"] for h in holds.values() for p in h["partings"]}
    differ = [i for i, (a, b) in enumerate(zip(cont["answers"],
                                               convoy["answers"]))
              if [x["tokens"] for x in a] != [x["tokens"] for x in b]]
    if set(differ) - parted:
        raise AssertionError(f"continuous and convoy answers differ at "
                             f"{sorted(set(differ) - parted)} without a "
                             "near-tie")
    if device == "cuda":
        _check_session_launches("continuous batching", cont)
        _check_cell_route("convoy generate",
                          convoy["kernels"]["gru_cell_infer"],
                          "gru_cell_infer")
        # the encoder's two GRUs run their primal kernel at each admission
        enc = cont["kernels"]["gru_seq"]
        if enc["launches"] not in (2 * SERVE16_SOURCES,
                                   2 * SERVE16_SOURCES + 2):
            raise AssertionError(f"gru_seq launched {enc} at "
                                 f"{SERVE16_SOURCES} admissions")
    out = {key: dict({k: v for k, v in mode.items() if k != "answers"},
                     answer_lengths=[[len(b["tokens"]) for b in a]
                                     for a in mode["answers"]],
                     device_decode_steps=mode["kernels"]["gru_cell_infer"][
                         "launches"], **holds[key])
           for key, mode in modes.items()}
    out["modes_differ_at"] = differ
    return out


def _scoring_holds(tiers, files, rows, peak_rows, feeding, device):
    """(b)'s checks after the servers stopped: each tier's /healthz, its
    scores against fp32's and the CPU plain path's on the same file, its
    launches, its resident and peak parameter bytes."""
    from paddle_tpu_torch import quant as quant_lib
    from paddle_tpu_torch.serving import ServingPredictor
    out = {}
    for dt, tier in tiers.items():
        gate, quant = tier["quant"]["gate"], tier["quant"]
        if dt == "fp32":
            if quant != {"dtype": "fp32", "gate": None}:
                raise AssertionError(f"fp32 quant block {quant}")
        elif not (quant["dtype"] == dt and gate["checked"] and gate["passed"]
                  and gate["max_delta"] <= gate["tol"]
                  and tier["model_version"].endswith("+" + dt)):
            raise AssertionError(f"{dt}: /healthz {quant}, version "
                                 f"{tier['model_version']}")
        ref = ServingPredictor.from_merged(
            files[dt], feeding, batch_buckets=_batch_buckets(MAX_BATCH),
            length_buckets=LENGTH_BUCKETS, device="cpu")
        want = ref.predict_rows([tuple(r) for r in rows])[0]["output"][
            :len(rows)]
        cpu_err = float(np.abs(tier["scores"] - want).max())
        if not cpu_err <= 1e-5:
            raise AssertionError(f"{dt}: served scores {cpu_err} from the "
                                 "CPU plain path on the same file")
        lstm = tier["lstm_seq"]
        if device == "cuda" and (
                lstm["launches"] != MODEL["num_layers"] * tier["batches"]
                or lstm["step_launches"] != lstm["launches"]):
            raise AssertionError(f"{dt}: lstm_seq {lstm} in "
                                 f"{tier['batches']} batches, one "
                                 "persistent launch a layer and batch "
                                 "expected")
        out[dt] = dict({k: v for k, v in tier.items() if k != "scores"},
                       max_abs_err_vs_cpu=cpu_err,
                       **_param_memory(files[dt], feeding, peak_rows,
                                       device))
        if dt != "fp32":
            delta = quant_lib.gate_delta(tier["scores"],
                                         tiers["fp32"]["scores"])
            tol = quant_lib.GATE_TOLERANCES[dt]
            if not delta <= tol:
                raise AssertionError(f"{dt}: scores {delta} from fp32's, "
                                     f"past {tol}")
            out[dt]["delta_vs_fp32"] = delta
    if device == "cuda":
        fp32_bytes = out["fp32"]["resident_bytes"]
        for dt, most in (("int8", 0.3), ("bf16", 0.55)):
            share = out[dt]["resident_bytes"] / fp32_bytes
            out[dt]["resident_share_of_fp32"] = share
            if not share <= most:
                raise AssertionError(f"{dt} holds {share:.3f} of fp32's "
                                     f"parameter bytes, more than {most}")
    return out


def serving_tier(tmp, s2s_dir, conf, save_dir, fp32_model, device="cuda"):
    """Phase 16: (a) continuous batching against convoy and the
    stand-down, (b) the fp32, bf16 and int8 tiers of the classifier and a
    drifted int8 file, (c) int8 generation with continuous batching, all
    through ``--job merge`` and ``--job serve`` processes; the servers
    start together and are measured one at a time, the CPU references
    after they stop. Returns its row, with the kernel launches of its
    servers under ``launches``."""
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()  # the servers share the card
    gen_conf = os.path.join(tmp, "s2s_gen16_conf.py")
    _write_gen_config(gen_conf)
    gen_model = _merge16(gen_conf, s2s_dir,
                         os.path.join(tmp, "s2s_gen16.ptmodel"), device)
    qgen_model = _merge16(gen_conf, s2s_dir,
                          os.path.join(tmp, "s2s_gen16.int8.ptmodel"),
                          device, "int8")
    files = dict(fp32=fp32_model, **{
        dt: _merge16(conf, save_dir, os.path.join(
            tmp, f"lstm_text_h1280.{dt}.ptmodel"), device, dt)
        for dt in QUANT_TIERS[1:]})
    gen_feeding = {"source_words": integer_value_sequence(S2S["src_vocab"])}
    feeding = {"words": integer_value_sequence(MODEL["vocab_size"]),
               "label": integer_value(MODEL["classes"])}
    drifted, corruption = _drifted_int8(tmp, files["int8"], feeding, device)
    rng = np.random.default_rng(SEED + 16)
    sources = [[rng.integers(2, S2S["src_vocab"], size=int(n)).tolist()]
               for n in rng.integers(1, S2S_LEN + 1, size=SERVE16_SOURCES)]
    rng = np.random.default_rng(SEED + 17)

    def row(n):
        return [rng.integers(0, MODEL["vocab_size"], size=int(n)).tolist(),
                int(rng.integers(0, MODEL["classes"]))]

    rows = [row(n) for n in rng.integers(1, SEQLEN + 1, size=SERVE16_ROWS)]
    peak_rows = [tuple(row(n)) for n in rng.integers(1, SEQLEN + 1,
                                                     size=MAX_BATCH)]
    qsources = sources[:SERVE16_QGEN_SOURCES]
    dev, cont = ["--device", device], ["--serving_continuous_batching"]
    specs = {
        "gen16_continuous": _serve_cmd(gen_conf, gen_model,
                                       GEN_CONT_BUCKETS, GEN_MAX_BATCH,
                                       dev + cont),
        "gen16_convoy": _serve_cmd(gen_conf, gen_model, GEN_CONT_BUCKETS,
                                   GEN_MAX_BATCH, dev),
        "gen16_standdown": _serve_cmd(gen_conf, gen_model,
                                      GEN_LENGTH_BUCKETS, GEN_MAX_BATCH,
                                      dev + cont),
        "qgen16": _serve_cmd(gen_conf, qgen_model, GEN_CONT_BUCKETS,
                             GEN_MAX_BATCH, dev + cont),
        **{f"score16_{dt}": _serve_cmd(conf, files[dt], LENGTH_BUCKETS,
                                       MAX_BATCH, dev)
           for dt in QUANT_TIERS},
        "drifted16": _serve_cmd(conf, drifted, LENGTH_BUCKETS, MAX_BATCH,
                                dev)}
    # the CPU references run while the servers start, never while they
    # are measured
    refs = {}

    def cpu_refs():
        try:
            t = time.perf_counter()
            refs["a"] = _cpu_beams(gen_model, gen_feeding, sources)
            refs["c"] = _cpu_beams(qgen_model, gen_feeding, qsources)
            refs["seconds"] = time.perf_counter() - t
        except BaseException as e:  # noqa: BLE001 — raised below
            refs["error"] = e

    worker = threading.Thread(target=cpu_refs, daemon=True)
    worker.start()
    t1 = time.perf_counter()
    with _server_group(tmp, specs, refused=("drifted16",)) as group:
        worker.join()
        if "error" in refs:
            raise refs["error"]
        t2 = time.perf_counter()
        ports = group["ports"]
        modes = {key: _gen_mode(ports[f"gen16_{key}"], sources, key)
                 for key in ("continuous", "convoy")}
        port = ports["gen16_standdown"]
        status, body = _http(port, "POST", "/v1/generate",
                             {"sample": sources[0]})
        standdown_chunks = _metrics(port)["decode_chunks_total"]
        qgen = _gen_mode(ports["qgen16"], qsources, "qgen16")
        tiers = {dt: _score_tier(ports[f"score16_{dt}"], rows, dt)
                 for dt in QUANT_TIERS}
        t3 = time.perf_counter()
    exits, ready_s = group["exits"], group["ready_s"]
    t4 = time.perf_counter()
    # (a) the stand-down: two length buckets, convoy served
    if "continuous batching stood down" not in _log(tmp, "gen16_standdown"):
        raise AssertionError("two length buckets: no stand-down in the log")
    if status != 200 or standdown_chunks != 0:
        raise AssertionError(f"the stood-down server answered {status} "
                             f"with {standdown_chunks} session chunks")
    cb = _continuous_holds(modes, sources, gen_model, gen_feeding,
                           refs["a"], device)
    # (b) the tiers, and the drifted file never ready
    scoring = _scoring_holds(tiers, files, rows, peak_rows, feeding, device)
    log = _log(tmp, "drifted16")
    if exits["drifted16"] == 0 or "quant_gate" not in log:
        raise AssertionError(f"the drifted int8 file: exit "
                             f"{exits['drifted16']}, log {log[-2000:]}")
    # (c) int8 generation: the gate stands down by name
    gate = qgen["quant"]["gate"]
    if not (qgen["quant"]["dtype"] == "int8" and gate["checked"] is False
            and "generation-only" in gate["reason"]
            and qgen["model_version"].endswith("+int8")
            and "STOOD DOWN" in _log(tmp, "qgen16")):
        raise AssertionError(f"int8 generate: /healthz {qgen['quant']}")
    if device == "cuda":
        _check_session_launches("int8 continuous batching", qgen)
    worst, partings = _hold_beams(qgen["answers"], qsources, qgen_model,
                                  gen_feeding, refs["c"], device,
                                  "int8 generate")
    qgen_row = dict({k: v for k, v in qgen.items() if k != "answers"},
                    answer_lengths=[[len(b["tokens"]) for b in a]
                                    for a in qgen["answers"]],
                    max_rel_score_err_vs_cpu=worst, tie_flips=len(partings),
                    partings=partings)
    mode_rows = (modes["continuous"], modes["convoy"], qgen)
    launches = {
        "lstm_seq": sum(t["lstm_seq"]["launches"] for t in tiers.values()),
        "gru_seq": sum(m["kernels"]["gru_seq"]["launches"]
                       for m in mode_rows),
        "gru_cell_infer": sum(m["kernels"]["gru_cell_infer"]["launches"]
                              for m in mode_rows)}
    row = dict(continuous_batching=cb, quantized_scoring=dict(
                   rows=len(rows), tiers=scoring,
                   drifted=dict(corruption=corruption,
                                exit=exits["drifted16"],
                                refused="quant_gate")),
               quantized_generation=qgen_row, launches=launches,
               ready_s=ready_s, server_exits=exits,
               cpu_reference_s=refs["seconds"],
               standdown=dict(status=status, session_chunks=standdown_chunks),
               seconds=dict(files=t1 - t0, start_and_cpu=t2 - t1,
                            served=t3 - t2, stop=t4 - t3,
                            holds=time.perf_counter() - t4))
    phase("serving_tier", **row)
    return row


def serving():
    """``--serving``: phase 16 alone (one training pass of the classifier
    and of seq2seq for its files); its row in ``serving.json`` in
    ``OUT_DIR``."""
    build.build_all(["lstm_seq", "gru_seq", "gru_cell", "opt_update"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        conf = os.path.join(tmp, "train_conf.py")
        _write_config(conf, "optimizer = Adam(learning_rate=2e-3)")
        save_dir = os.path.join(tmp, "ckpt")
        _train_run(conf, 1, save_dir)
        model = os.path.join(tmp, "lstm_text_h1280.ptmodel")
        _cli_inproc(["--config", conf, "--job", "merge", "--save_dir",
                     save_dir, "--model_path", model])
        s2s_conf = os.path.join(tmp, "s2s_conf.py")
        _write_s2s_config(s2s_conf, S2S)
        s2s_dir = os.path.join(tmp, "s2s_ckpt")
        _train_run(s2s_conf, 1, s2s_dir, batches=S2S_BATCHES)
        row = serving_tier(tmp, s2s_dir, conf, save_dir, model)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "serving.json"), "w") as f:
        json.dump(row, f, indent=1)


# ------------------------------------------ 17. mixed-precision training
BF16_SHORT_T = 3  # the rounding-point check's steps, at the path shapes
BF16_LSTM_SHAPES = [(TRAIN_BATCH, MODEL["hidden"], SEQLEN),
                    (1, MODEL["hidden"], SEQLEN),
                    (TRAIN_BATCH, MODEL["hidden"], BF16_SHORT_T)]
BF16_GRU_SHAPES = [(DS2_BATCH, DS2["hidden"], DS2_MAX_T, False),
                   (DS2_BATCH, DS2["hidden"], DS2_MAX_T, True),
                   (1, DS2["hidden"], DS2_MAX_T, False),
                   (DS2_BATCH, DS2["hidden"], BF16_SHORT_T, False),
                   (DS2_BATCH, DS2["hidden"], BF16_SHORT_T, True)]
BF16_TOL = 2e-2  # values and gradients, of each tensor's largest entry
BF16_ULP_SHARE, BF16_ULPS = 1e-2, 4  # the short-T check (_bf16_ulps)
BF16_PASSES = 3  # the classifier's; the acoustic model trains one pass
_BF = torch.bfloat16


def _bf16_held(where, names, got, want, f32):
    """Each bf16 result against its plain bf16 version on the card,
    ``max|got - want| <= BF16_TOL * max|want|``, and no farther from the
    float32 computation of the same widened inputs than twice the plain
    version is, plus 1e-3 of the f32 result's largest entry. Returns
    the largest error and the largest error over the limit's entry."""
    err = share = 0.0
    for name, g, w, f in zip(names, got, want, f32):
        g, w, f = g.float(), w.float(), f.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{where} {name} is not finite")
        e = (g - w).abs().max().item()
        big = w.abs().max().item()
        mine = (g - f).abs().max().item()
        own = (w - f).abs().max().item()
        if not (e <= BF16_TOL * big and
                mine <= 2 * own + 1e-3 * f.abs().max().item()):
            raise AssertionError(
                f"{where} {name}: max abs err {e} (limit {BF16_TOL * big});"
                f" from f32 {mine} against the plain bf16's {own}")
        err, share = max(err, e), max(share, e / big if big else 0.0)
    return err, share


def _bf16_ulps(where, names, got, want):
    """The short-T check: each result keeps its plain version's bf16
    rounding points. An element whose sum order differs (the kernel's
    product against cuBLAS's) rounds the other way rarely (a CPU
    experiment at these shapes, the plain version with its hidden units
    permuted, parted at T = 3 in 0.04 % of the elements, by at most one
    ulp of the largest entry); a kernel that keeps f32 between two of the
    reference's roundings parts in 4-30 % of them by more than an ulp.
    Holds: at most ``BF16_ULP_SHARE`` of the elements more than one bf16
    ulp of their own plain value away, none more than ``BF16_ULPS`` ulps
    of the largest entry. Returns {name: (share, ulps of the largest)}."""
    def ulp(x):  # of bf16 at |x| (8 significant bits)
        e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
        return torch.exp2(e - 7)

    out = {}
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        share = (d > ulp(w)).float().mean().item()
        top = (d.max() / ulp(w.abs().max())).item()
        out[name] = (share, top)
        if not (share <= BF16_ULP_SHARE and top <= BF16_ULPS):
            raise AssertionError(
                f"{where} {name}: {share:.4%} of the elements beyond one "
                f"bf16 ulp (limit {BF16_ULP_SHARE:.0%}), {top} ulps of "
                f"the largest entry (limit {BF16_ULPS})")
    return out


def _bf16_bound(ops, bf16_elems, f32_elems):
    """Least time, ms: 2 bytes a bf16 element and 4 an f32 one over HBM,
    or the products at the dense BF16 rate; and which one it is."""
    t_ops = ops / BF16_FLOPS
    t_bytes = (2 * bf16_elems + 4 * f32_elems) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bf16_device_ms(fn, kernel, calls):
    """Device ms of one call of ``fn``: the mean of ``kernel``'s launches
    in one ``torch.profiler`` trace of ``calls`` calls (``_traced``), or
    None where the trace holds fewer than half of them (late in the full
    run the profiler returned whole traces without the GRU kernels, six
    tries in a row: one try here, and the CUDA-event time stands)."""
    fn()
    torch.cuda.synchronize()
    found = [e for e in _traced(fn, calls)[0] if kernel in e.key]
    n = sum(e.count for e in found)
    if not calls // 2 <= n <= calls:
        phase("bf16_profiler_missed", kernel=kernel, launches=n, calls=calls)
        return None
    return 1e-3 * sum(e.self_device_time_total for e in found) / n


def _bf16_rows(row, where, held, short=None):
    """``_bf16_held`` of each part of a check ({part: (names, got, want,
    f32)}) into ``row`` (``<part>_max_abs_err``, ``<part>_share`` of the
    largest entry), and ``_bf16_ulps`` at ``BF16_SHORT_T`` steps, or
    where ``short`` says (``<part>_ulps``)."""
    if short is None:
        short = row["T"] <= BF16_SHORT_T
    for part, (names, got, want, f32) in held.items():
        row[part + "_max_abs_err"], row[part + "_share"] = _bf16_held(
            f"{where} {part}", names, got, want, f32)
        if short:
            row[part + "_ulps"] = _bf16_ulps(f"{where} {part}", names, got,
                                             want)


def check_bf16_lstm(B, H, T, seed, timed):
    """K1 and K2 at (B, H, T): the residual and primal forward kernels'
    bf16 form (bias unfolded, ys f32, the rest bf16) and the chain's,
    each against its plain bf16 version on the card (``_bf16_held``; the
    inputs ``_inputs``' at bf16, a ragged mask); ``timed``: CUDA-event ms,
    profiler device ms, the f32 form's ms at the widened inputs, the plain
    version's ms and the bound. At ``BF16_SHORT_T`` steps also
    ``_bf16_ulps``."""
    a = _inputs(B, H, T, seed)
    b = {k: v.to(_BF) for k, v in a.items() if k != "mask"}
    f = {k: v.float() for k, v in b.items()}
    mask = a["mask"]
    args = (b["xs"], mask, b["w"], b["pI"], b["pF"], b["pO"], b["h0"],
            b["c0"])
    f_args = ((f["xs"] + f["bias"]).contiguous(), mask, f["w"], f["pI"],
              f["pF"], f["pO"], f["h0"], f["c0"])
    where = f"bf16 LSTM B={B} H={H} T={T}"
    res = L.lstm_seq_train(*args, gate_bias=b["bias"])
    res_p = L.lstm_sequence_residual_plain(*args, gate_bias=b["bias"])
    res_f = L.lstm_sequence_residual_plain(*f_args)
    torch.cuda.synchronize()
    if [t.dtype for t in res] != [torch.float32, _BF, _BF, _BF]:
        raise AssertionError(f"{where}: residual dtypes {res}")
    row = dict(B=B, H=H, T=T)
    held = {}
    held["fwd"] = (("ys", "hs", "cs", "gates"), res, res_p, res_f)
    prim = L.lstm_seq(*args, gate_bias=b["bias"])
    prim_p = L.lstm_sequence_plain(*args, gate_bias=b["bias"])
    prim_f = L.lstm_sequence_plain(*f_args)
    held["primal"] = (("ys", "hT", "cT"), prim, prim_p, prim_f)
    dys, dhT, dcT = _cotangents(B, H, T, seed + 1)
    _, hs, cs, gates = res_p
    chain_args = (dys, mask, gates, cs, b["c0"], b["w"], b["pI"], b["pF"],
                  b["pO"], dhT.to(_BF), dcT.to(_BF))
    chain = L.lstm_bwd_chain(*chain_args)
    # the plain chain over one block (the kernel's blocked arrangement is
    # held against one block on the CPU, tests/test_torch_rnn_bf16.py)
    chain_p = L.lstm_bwd_chain_plain(*chain_args)
    chain_f = L.lstm_bwd_chain_plain(dys, mask, res_f[3], res_f[2], f["c0"],
                                     f["w"], f["pI"], f["pF"], f["pO"], dhT,
                                     dcT)
    torch.cuda.synchronize()
    held["chain"] = (("dxs", "dh0", "dc0"), chain, chain_p, chain_f)
    _bf16_rows(row, where, held)
    if not timed:
        return row
    calls = 10
    run = lambda: L.lstm_seq_train(*args, gate_bias=b["bias"])
    run_p = lambda: L.lstm_seq(*args, gate_bias=b["bias"])
    run_c = lambda: L.lstm_bwd_chain(*chain_args)
    f_res = L.lstm_sequence_residual_plain(*f_args)
    f_chain = (dys, mask, f_res[3], f_res[2], f["c0"], f["w"], f["pI"],
               f["pF"], f["pO"], dhT, dcT)
    bh, tbh = B * H, T * B * H
    w_elems, vec = 4 * H * H, 7 * H
    # the bf16 forms' kernels (tensor cores) and the f32 forms' beside them
    fwd_k, chain_k = (("lstm_bf16_kernel", "lstm_persistent_kernel"),
                      ("lstm_bf16_chain_kernel", "lstm_bwd_chain_kernel"))
    for key, fn, f_fn, plain, kernel, bound in (
            ("fwd_", run, lambda: L.lstm_seq_train(*f_args),
             lambda: L.lstm_sequence_residual_plain(
                 *args, gate_bias=b["bias"]), fwd_k,
             _bf16_bound(8.0 * B * H * H * T,
                         4 * tbh + w_elems + vec + 2 * bh + 2 * tbh
                         + 4 * tbh, T * B + tbh)),
            ("primal_", run_p, lambda: L.lstm_seq(*f_args),
             lambda: L.lstm_sequence_plain(*args, gate_bias=b["bias"]),
             fwd_k,
             _bf16_bound(8.0 * B * H * H * T,
                         4 * tbh + w_elems + vec + 4 * bh, T * B + tbh)),
            ("chain_", run_c, lambda: L.lstm_bwd_chain(*f_chain),
             lambda: L.lstm_bwd_chain_plain(*chain_args),
             chain_k,
             _bf16_bound(8.0 * B * H * H * T,
                         4 * tbh + tbh + w_elems + 3 * H + 5 * bh
                         + 4 * tbh, T * B + tbh))):
        row[key + "ms"] = _time_ms(fn)
        row[key + "device_ms"] = _bf16_device_ms(fn, kernel[0], calls)
        row[key + "f32_ms"] = _time_ms(f_fn)
        row[key + "f32_device_ms"] = _bf16_device_ms(f_fn, kernel[1], calls)
        row[key + "plain_ms"] = _time_ms(plain, reps=3, warmup=1)
        row[key + "bound_ms"], row[key + "bound_by"] = bound
        row[key + "library_ms"] = None
    return row


def check_bf16_gru(B, H, T, reverse, seed, timed):
    """K3 and K4 at (B, H, T) as the acoustic model's first layer runs
    them (``reverse``: its backward GRU, on time-flipped inputs): the
    residual and primal forward kernels' bf16 form and the chain's, with
    the two column slices of one bf16 w0 as the weights, against their
    plain bf16 versions on the card; ``timed`` and ``BF16_SHORT_T`` as
    ``check_bf16_lstm``."""
    a = _gru_inputs(B, H, T, seed)
    xs = (a["xs"].to(_BF) + a["bias"].to(_BF))  # the layer's bf16 fold
    mask = a["mask"]
    if reverse:
        xs, mask = xs.flip(0).contiguous(), mask.flip(0).contiguous()
    w0 = torch.cat([a["wg"], a["ws"]], dim=1).to(_BF)
    h0 = a["h0"].to(_BF)
    wg, ws = w0[:, :2 * H], w0[:, 2 * H:]
    w0f = w0.float()
    args = (xs, mask, wg, ws, h0)
    f_args = (xs.float(), mask, w0f[:, :2 * H], w0f[:, 2 * H:], h0.float())
    where = f"bf16 GRU B={B} H={H} T={T} reverse={reverse}"
    res = G.gru_seq_train(*args)
    res_p = G.gru_sequence_residual_plain(*args)
    res_f = G.gru_sequence_residual_plain(*f_args)
    torch.cuda.synchronize()
    if [t.dtype for t in res] != [torch.float32, _BF, _BF]:
        raise AssertionError(f"{where}: residual dtypes {res}")
    row = dict(B=B, H=H, T=T, reverse=reverse,
               units=G.gru_plan(B, H, bf16=True)["units"],
               chain_bit_equal=True)
    held = {"fwd": (("ys", "hs", "gates"), res, res_p, res_f),
            "primal": (("ys", "hT"), G.gru_seq(*args),
                       G.gru_sequence_plain(*args),
                       G.gru_sequence_plain(*f_args))}
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dys = torch.randn((T, B, H), generator=g, device="cuda")
    dhT = torch.randn((B, H), generator=g, device="cuda")
    _, hs, gates = res_p
    chain_args = (dys, mask, gates, h0, hs, wg, ws, dhT.to(_BF))
    chain = G.gru_bwd_chain(*chain_args)
    # the plain chain over one block: over the kernel's 64 blocks of 16
    # units it is ~10^5-10^6 small launches a call (its arrangement is
    # held against one block on the CPU, tests/test_torch_rnn_bf16.py)
    chain_p = G.gru_bwd_chain_plain(*chain_args)
    if not all(torch.equal(u, w) for u, w in zip(
            chain, G.gru_bwd_chain(*chain_args))):
        raise AssertionError(f"{where}: two chain runs differ")
    chain_f = G.gru_bwd_chain_plain(dys, mask, res_f[2], h0.float(),
                                    res_f[1], *f_args[2:4], dhT)
    torch.cuda.synchronize()
    held["chain"] = (("dxs", "dh0"), chain, chain_p, chain_f)
    _bf16_rows(row, where, held)
    if not timed:
        return row
    calls = 5
    f_res = G.gru_sequence_residual_plain(*f_args)
    f_chain = (dys, mask, f_res[2], h0.float(), f_res[1], *f_args[2:4], dhT)
    bh, tbh = B * H, T * B * H
    # the bf16 forms' kernels (tensor cores) and the f32 forms' beside them
    fwd_k = ("gru_bf16_kernel", "gru_persistent_kernel")
    chain_k = ("gru_bf16_chain_kernel", "gru_bwd_chain_kernel")
    for key, fn, f_fn, plain, kernel, bound in (
            ("fwd_", lambda: G.gru_seq_train(*args),
             lambda: G.gru_seq_train(*f_args),
             lambda: G.gru_sequence_residual_plain(*args), fwd_k,
             _bf16_bound(6.0 * B * H * H * T,
                         3 * tbh + 3 * H * H + bh + tbh + 3 * tbh,
                         T * B + tbh)),
            ("primal_", lambda: G.gru_seq(*args),
             lambda: G.gru_seq(*f_args),
             lambda: G.gru_sequence_plain(*args), fwd_k,
             _bf16_bound(6.0 * B * H * H * T,
                         3 * tbh + 3 * H * H + 2 * bh, T * B + tbh)),
            ("chain_", lambda: G.gru_bwd_chain(*chain_args),
             lambda: G.gru_bwd_chain(*f_chain),
             lambda: G.gru_bwd_chain_plain(*chain_args), chain_k,
             _bf16_bound(6.0 * B * H * H * T,
                         3 * tbh + bh + tbh + 3 * H * H + bh + 3 * tbh + bh,
                         tbh + T * B))):
        row[key + "ms"] = _time_ms(fn)
        row[key + "device_ms"] = _bf16_device_ms(fn, kernel[0], calls)
        row[key + "f32_ms"] = _time_ms(f_fn)
        row[key + "f32_device_ms"] = _bf16_device_ms(f_fn, kernel[1], calls)
        row[key + "plain_ms"] = _time_ms(plain, reps=3, warmup=1)
        row[key + "bound_ms"], row[key + "bound_by"] = bound
        row[key + "library_ms"] = None
    return row


@contextlib.contextmanager
def _plain_bf16_forms():
    """The bf16 forms' wrappers (K1-K4, flash's and the CRF's forward and
    backward) replaced by their plain bf16 versions on the card (PyTorch's operations, cuBLAS's products: the
    same bf16 rounding points, other sums' orders); float32 calls go to
    the kernels as before. The witness of ``_bf16_grads``."""
    swaps = [(L, "lstm_seq", 0, L.lstm_sequence_plain),
             (L, "lstm_seq_train", 0, L.lstm_sequence_residual_plain),
             (L, "lstm_bwd_chain", 3, L.lstm_bwd_chain_plain),
             (G, "gru_seq", 0, G.gru_sequence_plain),
             (G, "gru_seq_train", 0, G.gru_sequence_residual_plain),
             (G, "gru_bwd_chain", 4, G.gru_bwd_chain_plain),
             (ATT, "flash_fwd", 0, ATT.blockwise_plain),
             (ATT, "flash_bwd", 0, ATT.flash_bwd_plain),
             (CRF, "crf_alpha_fwd", 0, CRF.crf_forward_plain),
             (CRF, "crf_bwd", 0, CRF.crf_bwd_plain)]
    kernels = {(mod, name): getattr(mod, name) for mod, name, _, _ in swaps}

    def swap(kernel, at, plain):
        # the wrapper's counters copied (the float32 wrappers count their
        # launches through their module's name, the swap while it stands;
        # the kernel's own counts stay as they were)
        @functools.wraps(kernel)
        def fn(*args, **kw):
            if args[at].dtype != _BF:
                return kernel(*args, **kw)
            for key in ("per_step", "two_launch", "in_global"):
                kw.pop(key, None)
            return plain(*args, **kw)
        return fn

    try:
        for mod, name, at, plain in swaps:
            setattr(mod, name, swap(kernels[(mod, name)], at, plain))
        yield
    finally:
        for (mod, name), kernel in kernels.items():
            setattr(mod, name, kernel)


def _bf16_grads(where, build_model, feed, optimizer, rows):
    """The first step's loss and every parameter gradient at bf16 compute
    (the initial parameters of ``--seed SEED``, the first training
    batch): the card (the bf16 kernels) against the plain bf16 path on
    the CPU; every gradient f32 on the f32 masters. Each tensor no
    farther from the CPU's float32 gradient than twice the CPU's bf16
    one, plus 1e-3 of the f32 gradient's largest entry; and within
    ``BF16_TOL`` of the largest entry of the CPU's bf16 gradient, wherever
    that gradient itself lies within that bound of the f32 one. Where it
    does not (``noise_dominated``: at the initial parameters the weight
    gradients of the classifier's embedding, projections and recurrences
    are batch sums that cancel, and bf16's rounding of their terms moves
    them by 9-34 % of their largest entry), the tensor is held within
    twice the distance between the CPU's bf16 gradient and a witness's:
    the same bf16 computation on the card with the plain bf16 versions
    in place of the bf16 kernels (``_plain_bf16_forms``), which differs
    from the CPU's in its sums' order alone. ``vs_witness``: the kernels'
    gradient against the witness's. The per-tensor errors are printed
    before any check fails."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost = build_model()[0]
    runs = {}
    for key, device, dt in (("cuda", "cuda", "bfloat16"),
                            ("witness", "cuda", "bfloat16"),
                            ("cpu", "cpu", "bfloat16"),
                            ("cpu_f32", "cpu", None)):
        tr = SGD(cost, device=device, update_equation=optimizer, seed=SEED,
                 compute_dtype=dt)
        t0 = time.perf_counter()
        with (_plain_bf16_forms() if key == "witness"
              else contextlib.nullcontext()):
            _, loss, grads, _ = tr.loss_and_grads(tr._to_device(feed))
        if any(g.dtype != torch.float32 for g in grads.values()):
            raise AssertionError(f"{key}: a gradient is not f32")
        runs[key] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                     time.perf_counter() - t0)
        del tr
    names = sorted(runs["cpu"][1])
    per = {}
    for n in names:
        g, x, w, f = (runs[k][1][n] for k in ("cuda", "witness", "cpu",
                                              "cpu_f32"))
        dist = lambda u, v: (u - v).abs().max().item()
        e = per[n] = dict(err=dist(g, w),
                          limit=BF16_TOL * w.abs().max().item(),
                          from_f32=dist(g, f), cpu_from_f32=dist(w, f),
                          f32_max=f.abs().max().item(),
                          witness=dist(x, w), vs_witness=dist(g, x))
        e["noise_dominated"] = e["cpu_from_f32"] > e["limit"]
        if e["noise_dominated"]:
            e["limit"] = 2 * e["witness"]
    row = dict(loss_cuda=runs["cuda"][0], loss_witness=runs["witness"][0],
               loss_cpu=runs["cpu"][0], loss_cpu_f32=runs["cpu_f32"][0],
               rows=rows, grads=per,
               noise_dominated=[n for n in names
                                if per[n]["noise_dominated"]],
               seconds={k: v[2] for k, v in runs.items()})
    phase(where, **row)
    for n in names:
        e = per[n]
        if not (e["from_f32"] <= 2 * e["cpu_from_f32"] + 1e-3 * e["f32_max"]
                and e["err"] <= e["limit"]):
            raise AssertionError(f"{where} {n}: {e}")
    row["max_abs_err"] = max(per[n]["err"] for n in names)
    loss_g, loss_c = runs["cuda"][0], runs["cpu"][0]
    if not np.isfinite(loss_g) or abs(loss_g - loss_c) > BF16_TOL * \
            abs(loss_c):
        raise AssertionError(f"bf16 loss on the card {loss_g}, on the CPU "
                             f"{loss_c}")
    return row


def _f32_masters(save_dir):
    """Every master parameter and optimizer slot of the newest checkpoint
    is float32."""
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    params, opt = load_params(latest_checkpoint(save_dir))
    slots = {k: v for k, v in (opt or {}).items() if k.startswith("slots/")}
    bad = [k for k, v in {**params, **slots}.items()
           if np.asarray(v).dtype != np.float32]
    if bad or not slots:
        raise AssertionError(f"not float32 after bf16 training: {bad} "
                             f"({len(slots)} slots)")
    return len(params), len(slots)


def _bf16_counts(where, counts, expect):
    """The launches of a bf16 run: {counter name: expected}."""
    got = {k: counts[k]["launches"] for k in expect}
    if got != expect:
        raise AssertionError(f"{where}: launches {got}, expected {expect}")


def _bf16_traces(build_model, save_dir, optimizer, feed, f32_trace):
    """The traced bf16 step from ``save_dir``'s checkpoint beside the f32
    step: ``f32_trace`` (the same run's f32 trace of the model, phase 8's
    or 11c's) or, alone, the f32 step from the same checkpoint."""
    traces = {"bfloat16": _step_trace(build_model, save_dir, optimizer, feed,
                                      compute_dtype="bfloat16")}
    traces["float32"] = f32_trace or _step_trace(build_model, save_dir,
                                                 optimizer, feed)
    return traces


def bf16_classifier(tmp, f32_trace=None):
    """17(b): the classifier at full width with ``--compute_dtype
    bfloat16``: --job train (4 batches x 3 passes, Adam(2e-3)), --job test,
    --job time; lstm0 on the bf16 forms (K1, K2), lstm1 on the f32 forms
    (its f32 inputs promote); the masters and slots f32; the first step's
    gradients (the initial parameters, the first batch) card against the
    CPU plain bf16 path (``_bf16_grads``); a traced step at bf16 and at
    f32 from the same checkpoint."""
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, "bf16_conf.py")
    _write_config(conf, "optimizer = Adam(learning_rate=2e-3)")
    save_dir = os.path.join(tmp, "bf16_ckpt")
    bf = ["--compute_dtype", "bfloat16"]
    costs, summary = _train_run(conf, BF16_PASSES, save_dir, extra=bf)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"bf16 pass costs {costs} do not fall")
    steps = summary["steps"]
    counts = summary["kernels"]
    _bf16_counts("bf16 --job train", counts, {
        "lstm_seq_train_bf16": steps, "lstm_seq_train": steps,
        "lstm_bwd_chain_bf16": steps, "lstm_bwd_chain": steps,
        "lstm_bwd_step": 0, "adam": steps})
    n_params, n_slots = _f32_masters(save_dir)
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir, *bf])
    test_line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    test_counts = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("test_summary "))[13:])[
        "kernels"]
    if test_counts["lstm_seq_bf16"]["launches"] <= 0 or test_counts[
            "lstm_seq"]["launches"] != test_counts["lstm_seq_bf16"][
            "launches"]:
        raise AssertionError(f"bf16 --job test launches {test_counts}")
    from paddle_tpu_torch.trainer.checkpoint import latest_checkpoint
    out = _cli_inproc(["--config", conf, "--job", "time", "--init_model_path",
                       latest_checkpoint(save_dir), "--time_batches", "4",
                       "--time_warmup", "1", *bf])
    time_line = next(ln for ln in out.splitlines()
                     if ln.startswith("TimeInfo: "))
    time_counts = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("time_summary "))[13:])[
        "kernels"]
    grads = _bf16_grads("bf16_classifier_grads",
                        lambda: lstm_text_classifier(**MODEL),
                        _classifier_rows(TRAIN_BATCH),
                        Adam(learning_rate=2e-3), TRAIN_BATCH)
    traces = _bf16_traces(lambda: lstm_text_classifier(**MODEL), save_dir,
                          Adam(learning_rate=2e-3), _classifier_batch(),
                          f32_trace)
    return dict(pass_costs=costs, steps=steps,
                median_step_ms=summary["median_step_ms"], kernels=counts,
                f32_parameters=n_params, f32_slots=n_slots, test=test_line,
                test_kernels=test_counts, time=time_line,
                time_kernels=time_counts, grad_check=grads,
                step_trace=traces)


def _classifier_rows(rows):
    """The first training batch's first ``rows`` rows, CPU-fed (the
    config's reader: the same seed)."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    rng = np.random.default_rng(SEED)
    batch = []
    for n in rng.integers(1, SEQLEN + 1, size=TRAIN_BATCH):
        ids = rng.integers(0, MODEL["vocab_size"], size=int(n))
        low = (ids < MODEL["vocab_size"] // 2).mean()
        batch.append((ids.tolist(), int(low > 0.5)))
    return DataFeeder({"words": integer_value_sequence(MODEL["vocab_size"]),
                       "label": integer_value(MODEL["classes"])},
                      pad_multiple=SEQLEN, device="cpu")(batch[:rows])


def bf16_acoustic(tmp, f32_trace=None):
    """17(c): the CTC acoustic model at DeepSpeech2's width with
    ``--compute_dtype bfloat16``: one pass of --job train, --job test; the
    first layer's two GRUs on the bf16 forms (K3, K4), layers 2 and 3 on
    the f32 forms, CTC's f32 kernels, Adam once a step; the masters f32;
    the first batch's gradients (its DS2_BATCH rows) card against the CPU
    plain bf16 path (``_bf16_grads``); a traced step at bf16 and at
    f32."""
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, "bf16_acoustic_conf.py")
    _write_ds2_config(conf)
    save_dir = os.path.join(tmp, "bf16_acoustic_ckpt")
    bf = ["--compute_dtype", "bfloat16"]
    out = _cli_inproc(["--config", conf, "--job", "train", "--num_passes",
                       "1", "--seed", str(SEED), "--save_dir", save_dir,
                       *bf])
    costs = [float(ln.split("cost=")[1].split()[0])
             for ln in out.splitlines() if ln.startswith("Pass ")]
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    steps = summary["steps"]
    if len(costs) != 1 or steps != DS2_BATCHES or not np.isfinite(costs[0]):
        raise AssertionError(f"bf16 acoustic train printed {costs}, "
                             f"{summary}")
    first, rest = 2 * steps, 2 * (DS2["layers"] - 1) * steps
    counts = summary["kernels"]
    _bf16_counts("bf16 acoustic --job train", counts, {
        "gru_seq_train_bf16": first, "gru_seq_train": rest,
        "gru_bwd_chain_bf16": first, "gru_bwd_chain": rest,
        "gru_bwd_step": 0, "ctc_fused_fwd": steps, "ctc_fused_bwd": steps,
        "adam": steps})
    n_params, n_slots = _f32_masters(save_dir)
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir, *bf])
    test_line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    test_counts = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("test_summary "))[13:])[
        "kernels"]
    if test_counts["gru_seq_bf16"]["launches"] <= 0 or test_counts[
            "ctc_fused_fwd"]["launches"] <= 0:
        raise AssertionError(f"bf16 acoustic --job test launches "
                             f"{test_counts}")
    ns, dsl = _ds2_ns()
    # the first training batch (the config's reader)
    batch = ns["utterances"](np.random.default_rng(SEED), DS2_BATCH)
    grads = _bf16_grads("bf16_acoustic_grads",
                        lambda: ns["acoustic_model"](dsl),
                        _ds2_feeder("cpu")(batch),
                        Adam(learning_rate=DS2_LR), len(batch))
    traces = _bf16_traces(lambda: ns["acoustic_model"](dsl), save_dir,
                          Adam(learning_rate=DS2_LR), _ds2_feeder("cpu")(
                              batch), f32_trace)
    return dict(pass_costs=costs, steps=steps,
                median_step_ms=summary["median_step_ms"], kernels=counts,
                f32_parameters=n_params, f32_slots=n_slots, test=test_line,
                test_kernels=test_counts, grad_check=grads,
                step_trace=traces)


def bf16_refusals():
    """17(d): a bf16 CUDA tensor into a kernel form with no bf16 form
    raises (no quiet upcast): flash's wide-head and split-row paths, the
    CRF's block forms (C > 32), CTC, the GRU and LSTM cells with a bf16
    state, the per-step backward routes, the optimizers."""
    from paddle_tpu_torch.kernels import opt_update
    from paddle_tpu_torch.optim import Adam, Momentum
    d = dict(device="cuda", dtype=_BF)
    B, T, H, K = 2, 8, 32, 5
    m = torch.ones(B, T, device="cuda")
    cases = {
        "flash_fwd_wide": lambda: ATT.flash_fwd(
            *(torch.randn(B, 2, T, 256, **d) for _ in range(3))),
        "flash_bwd_split": lambda: ATT.flash_bwd(
            *(torch.randn(B, 2, T, 1056, **d) for _ in range(3)), None,
            torch.randn(B, 2, T, 1056, **d),
            torch.zeros(2, 2 * B, T, device="cuda"),
            torch.randn(B, 2, T, 1056, **d)),
        "crf_alpha_fwd_block": lambda: CRF.crf_alpha_fwd(
            torch.randn(B, T, 40, **d), m.to(_BF), torch.randn(40, 40, **d),
            torch.randn(40, **d), torch.randn(40, **d)),
        "crf_viterbi_block": lambda: CRF.crf_viterbi(
            torch.randn(B, T, 40, **d), m.to(_BF), torch.randn(40, 40, **d),
            torch.randn(40, **d), torch.randn(40, **d)),
        "ctc_fused_fwd": lambda: CTC.ctc_fused_fwd(
            torch.randn(B, T, K, **d), torch.zeros(B, 3, dtype=torch.int32,
                                                   device="cuda"),
            m, torch.ones(B, 3, device="cuda"), K - 1),
        "gru_cell": lambda: C.gru_cell(
            torch.randn(B, 3 * H, **d), torch.randn(B, H, **d),
            torch.randn(H, 2 * H, **d), torch.randn(H, H, **d)),
        "lstm_cell": lambda: C.lstm_cell(
            torch.randn(B, 4 * H, **d), torch.randn(B, H, **d),
            *(torch.randn(H, **d) for _ in range(3))),
        "lstm_bwd_step": lambda: L.lstm_bwd_step(
            *(torch.randn(*s, **d) for s in (
                (B, H), (B,), (B, 4 * H), (B, H), (B, H), (H,), (H,), (H,),
                (B, H), (B, H), (B, H), (B, 4 * H)))),
        "gru_bwd_step": lambda: G.gru_bwd_step(
            *(torch.randn(*s, **d) for s in (
                (B, H), (B,), (B, 3 * H), (B, H), (H, 2 * H), (H, H),
                (B, H), (B, H), (B, 3 * H)))),
        "adam": lambda: opt_update.adam(
            Adam(learning_rate=1e-3), torch.randn(64, **d),
            torch.randn(64, **d), {"mom": torch.zeros(64, **d),
                                   "v": torch.zeros(64, **d)}, 1e-3, 0.0, 1),
        "momentum": lambda: opt_update.momentum(
            Momentum(learning_rate=1e-3, momentum=0.9), torch.randn(64, **d),
            torch.randn(64, **d), {"mom": torch.zeros(64, **d)}, 1e-3, 0.0),
    }
    refused = {}
    for name, call in cases.items():
        try:
            call()
        except ValueError as err:
            refused[name] = str(err)[:120]
            continue
        raise AssertionError(f"{name} took a bf16 CUDA tensor")
    torch.cuda.synchronize()
    return refused


# 17(e): the bf16 forms of flash (D <= 128) and of the CRF (C <= 32)
# flash: (B, N, Tq, Tk, D, causal, last kv row all padding): the seq2seq
# block's (batch 50 of 10-50 words, 4 heads of 128), two kv blocks both
# ways, batch 1, and the short shape of the rounding-point check
BF16_FLASH_SHAPES = [
    (S2S_BATCH, S2S_ATT["num_heads"], S2S_LEN, S2S_LEN,
     S2S["embed_dim"] // S2S_ATT["num_heads"], False, True),
    (2, 4, 300, 300, 128, False, True), (2, 4, 300, 300, 128, True, False),
    (1, 4, S2S_LEN, S2S_LEN, 128, False, False),
    (2, 4, 8, 8, 128, False, False)]
BF16_FLASH_SHORT_T = 8
# the long-sequence rows, timed: [2, 4, 4096, 4096, 128], not causal and
# causal (the f32 forms' T = 4096 shape of phase 7)
BF16_FLASH_LONG = [(2, 4, 4096, 4096, 128, False, False),
                   (2, 4, 4096, 4096, 128, True, False)]
# the CRF: the linear-CRF tagger's batch (16 of 10-80 words, 23 labels),
# batch 1, and the short shape
BF16_CRF_SHAPES = [(16, 80, 23), (1, 80, 23), (16, BF16_SHORT_T, 23)]
# 17(g): the linear-CRF tagger at the demo's widths
# (v1_api_demo/sequence_tagging/linear_crf.py with the CoNLL-2000
# dictionaries tools/accuracy_run.py records: 76,328 features, 23 chunk
# labels), batches of 16 synthetic sentences of 10-80 words, about 30
# features a word, Adam
LCRF = dict(features=76328, labels=23)
LCRF_BATCH, LCRF_BATCHES, LCRF_TEST_BATCHES = 16, 4, 2
LCRF_MIN_LEN, LCRF_MAX_LEN, LCRF_WORD_FEATURES = 10, 80, 30
LCRF_GRAD_ROWS = 8

_LINEAR_CRF = """
def linear_crf(dsl, ParamAttr):
    crfw = ParamAttr(name="crfw")
    feats = dsl.data(name="features", size={F}, is_sequence=True)
    chunk = dsl.data(name="chunk", size={C}, is_sequence=True)
    crf_input = dsl.fc(input=feats, size={C}, act="linear", bias_attr=False,
                       name="crf_input")
    cost = dsl.crf_layer(input=crf_input, label=chunk, size={C},
                         param_attr=crfw, name="crf")
    decoded = dsl.crf_decoding_layer(input=crf_input, label=chunk, size={C},
                                     param_attr=crfw, name="crf_decoding")
    return cost, decoded, chunk


def sentences(rng, n):
    # words of about {K} distinct feature ids; a word's label is its first
    # drawn feature's id modulo the labels
    out = []
    for length in rng.integers({lo}, {hi} + 1, size=n):
        ids = rng.integers(0, {F}, size=(int(length), {K}))
        out.append(([sorted(set(w.tolist())) for w in ids],
                    [int(w[0]) % {C} for w in ids]))
    return out
""".format(F=LCRF["features"], C=LCRF["labels"], K=LCRF_WORD_FEATURES,
           lo=LCRF_MIN_LEN, hi=LCRF_MAX_LEN)


def _kernels_device_ms(fn, kernels):
    """The device ms of one call of ``fn``: the sum over its ``kernels``
    (each launched once a call) of ``_bf16_device_ms``; None where a
    trace lacked one."""
    dev = [_bf16_device_ms(fn, kernel, 10) for kernel in kernels]
    return None if None in dev else sum(dev)


def check_bf16_flash(B, N, Tq, Tk, D, causal, pad_row, seed, timed):
    """The bf16 forms of the flash kernels (``flash_fwd_bf16_kernel`` and
    the backward's ``flash_bwd_dq_bf16_kernel``, ``flash_bwd_dkdv_bf16
    _kernel``: bf16 tiles, ``mma.sync`` bf16) against
    ``blockwise_plain`` / ``flash_bwd_plain`` at bf16 on the same card
    tensors (``_bf16_held``: o, lse, dq, dk, dv), and at Tq = Tk <=
    ``BF16_FLASH_SHORT_T`` ``_bf16_ulps``; ``timed``: CUDA-event and
    profiler ms, the f32 forms' at the widened inputs, the plain ms, the
    bound (bf16 elements 2 bytes, the mask and statistics 4; the products
    at the dense BF16 rate) and SDPA at bf16 with the mask as a bias."""
    q, k, v, mask, do = _flash_inputs(B, N, Tq, Tk, D, seed,
                                      min(S2S_MIN_LEN, Tk), pad_row)
    q, k, v, do = (t.to(_BF) for t in (q, k, v, do))
    f = [t.float() for t in (q, k, v, do)]
    where = f"bf16 flash B={B} N={N} Tq={Tq} Tk={Tk} D={D} causal={causal}"
    o, lse = ATT.flash_fwd(q, k, v, mask, causal)
    grads = ATT.flash_bwd(q, k, v, mask, o, lse, do, causal)
    torch.cuda.synchronize()
    if o.dtype != _BF or any(t.dtype != _BF for t in grads):
        raise AssertionError(f"{where}: dtypes {o.dtype}, "
                             f"{[t.dtype for t in grads]}")
    p_o, p_lse = ATT.blockwise_plain(q, k, v, mask, causal)
    f_o, f_lse = ATT.blockwise_plain(*f[:3], mask, causal)
    held = {"fwd": (("o", "lse"), (o, lse), (p_o, p_lse), (f_o, f_lse)),
            "bwd": (("dq", "dk", "dv"), grads,
                    ATT.flash_bwd_plain(q, k, v, mask, p_o, p_lse, do,
                                        causal),
                    ATT.flash_bwd_plain(*f[:3], mask, f_o, f_lse, f[3],
                                        causal))}
    row = dict(B=B, N=N, Tq=Tq, Tk=Tk, D=D, causal=causal)
    _bf16_rows(row, where, held, short=Tk <= BF16_FLASH_SHORT_T)
    if not timed:
        return row
    visible = _flash_visible(B, Tq, Tk, mask, causal)
    pairs = N * float(visible.sum())
    q_el, kv_el = B * N * Tq * D, B * N * Tk * D
    stats = 2 * B * N * Tq
    for key, fn, f_fn, plain, kernels, bound in (
            ("fwd_", lambda: ATT.flash_fwd(q, k, v, mask, causal),
             lambda: ATT.flash_fwd(*f[:3], mask, causal),
             lambda: ATT.blockwise_plain(q, k, v, mask, causal),
             (("flash_fwd_bf16_kernel",), ("flash_fwd_kernel",)),
             _bf16_bound(4.0 * D * pairs, 2 * q_el + 2 * kv_el,
                         B * Tk + stats)),
            ("bwd_", lambda: ATT.flash_bwd(q, k, v, mask, o, lse, do, causal),
             lambda: ATT.flash_bwd(*f[:3], mask, f_o, f_lse, f[3], causal),
             lambda: ATT.flash_bwd_plain(q, k, v, mask, p_o, p_lse, do,
                                         causal),
             (("flash_bwd_dq_bf16_kernel", "flash_bwd_dkdv_bf16_kernel"),
              ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")),
             _bf16_bound(10.0 * D * pairs, 4 * q_el + 4 * kv_el,
                         B * Tk + stats))):
        row[key + "ms"] = _time_ms(fn)
        row[key + "device_ms"] = _kernels_device_ms(fn, kernels[0])
        row[key + "f32_ms"] = _time_ms(f_fn)
        row[key + "f32_device_ms"] = _kernels_device_ms(f_fn, kernels[1])
        row[key + "plain_ms"] = _time_ms(plain, reps=3, warmup=1)
        row[key + "bound_ms"], row[key + "bound_by"] = bound
    bias = torch.zeros((B, 1, Tq, Tk), device="cuda", dtype=_BF).masked_fill(
        ~visible[:, None], -1e9)
    lib = _library_times(q, k, v, do, p_o, D ** -0.5, "library",
                         attn_mask=bias)
    row.update(lib)
    return row


def check_bf16_crf(B, T, C, seed, timed):
    """The bf16 forms of the C <= 32 CRF kernels (``crf_alpha_warp_kernel``,
    ``crf_bwd_fused_kernel`` with ``crf_sum_kernel``,
    ``crf_decode_warp_kernel`` with S = bf16) against their plain bf16
    versions on the same card tensors (``_crf_inputs`` at bf16: ragged, an
    all-padding row, two forbidden transitions; the mask bf16 as the
    layer casts it): ``_bf16_held`` on alphas, log Z, dx, dtrans, da, db,
    ``_bf16_ulps`` at ``BF16_SHORT_T`` steps; the Viterbi's paths
    identical and its scores bit-equal. ``timed``: CUDA-event and
    profiler ms, the f32 forms' at the widened inputs, the plain ms, the
    bytes or operations bound (2 bytes a bf16 element) and the chain
    bound (the most live steps of a row times ``crf_chain_floor``'s step
    at C)."""
    x, mask, trans, a, b, g = (t.to(_BF) for t in _crf_inputs(B, T, C, seed))
    f = [t.float() for t in (x, mask, trans, a, b, g)]
    where = f"bf16 CRF B={B} T={T} C={C}"
    alphas, log_z = CRF.crf_alpha_fwd(x, mask, trans, a, b)
    grads = CRF.crf_bwd(x, mask, trans, b, alphas, log_z, g)
    path, score = CRF.crf_viterbi(x, mask, trans, a, b)
    torch.cuda.synchronize()
    p_alphas, p_log_z = CRF.crf_forward_plain(x, mask, trans, a, b)
    f_alphas, f_log_z = CRF.crf_forward_plain(*f[:5])
    held = {"fwd": (("alphas", "log_z"), (alphas, log_z),
                    (p_alphas, p_log_z), (f_alphas, f_log_z)),
            "bwd": (("dx", "dtrans", "da", "db"), grads,
                    CRF.crf_bwd_plain(x, mask, trans, b, p_alphas, p_log_z,
                                      g),
                    CRF.crf_bwd_plain(f[0], f[1], f[2], f[4], f_alphas,
                                      f_log_z, f[5]))}
    row = dict(B=B, T=T, C=C)
    _bf16_rows(row, where, held)
    p_path, p_score = CRF.crf_viterbi_plain(x, mask, trans, a, b)
    if not torch.equal(path, p_path) or not torch.equal(score, p_score):
        raise AssertionError(f"{where}: Viterbi paths differ at "
                             f"{int((path != p_path).sum())} steps, scores "
                             f"at {int((score != p_score).sum())} rows")
    row["viterbi_paths_equal"] = row["viterbi_scores_bit_equal"] = True
    if not timed:
        return row
    live = float(mask[:, 1:].float().sum())
    pairs = float((mask[:, 1:] * mask[:, :-1]).float().sum())
    ins = B * T * C + B * T + C * C + 2 * C
    steps = int(mask[:, 1:].float().sum(dim=1).max().item())
    row["chain_live_steps"] = steps
    for key, fn, f_fn, plain, kernels, bound, variant in (
            ("fwd_", lambda: CRF.crf_alpha_fwd(x, mask, trans, a, b),
             lambda: CRF.crf_alpha_fwd(*f[:5]),
             lambda: CRF.crf_forward_plain(x, mask, trans, a, b),
             ("crf_alpha_warp_kernel",),
             _bf16_bound(live * (2 * C * C + 6 * C) + 5.0 * B * C,
                         ins + B * T * C + B, 0), "alpha"),
            ("bwd_", lambda: CRF.crf_bwd(x, mask, trans, b, alphas, log_z, g),
             lambda: CRF.crf_bwd(f[0], f[1], f[2], f[4], f_alphas, f_log_z,
                                 f[5]),
             lambda: CRF.crf_bwd_plain(x, mask, trans, b, p_alphas, p_log_z,
                                       g),
             ("crf_bwd_fused_kernel", "crf_sum_kernel"),
             _bf16_bound(B * T * 6.0 * C + pairs * 7 * C * C
                         + live * (2 * C * C + 7 * C),
                         ins + B * T * C + 2 * B + B * T * C + C * C + 2 * C,
                         0), "beta"),
            ("viterbi_", lambda: CRF.crf_viterbi(x, mask, trans, a, b),
             lambda: CRF.crf_viterbi(*f[:5]),
             lambda: CRF.crf_viterbi_plain(x, mask, trans, a, b),
             ("crf_decode_warp_kernel",),
             _bf16_bound(live * (2 * C * C + C) + 3.0 * B * C, ins + B,
                         B * T), "viterbi")):
        row[key + "ms"] = _time_ms(fn)
        row[key + "device_ms"] = _kernels_device_ms(fn, kernels)
        row[key + "f32_ms"] = _time_ms(f_fn)
        row[key + "f32_device_ms"] = _kernels_device_ms(f_fn, kernels)
        row[key + "plain_ms"] = _time_ms(plain, reps=3, warmup=1)
        row[key + "bound_ms"], row[key + "bound_by"] = bound
        row[key + "floor_us"] = _crf_floor_us(C, variant)
        row[key + "chain_bound_ms"] = 1e-3 * steps * row[key + "floor_us"]
        row[key + "library_ms"] = None
    return row


def _s2s_bf16_rows():
    """seq2seq's first training batch's first ``S2S_GRAD_ROWS`` rows,
    CPU-fed (the config's reader: the same seed)."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    return DataFeeder(_s2s_feeding(), pad_multiple=S2S_LEN, device="cpu")(
        _s2s_samples(np.random.default_rng(SEED), S2S_BATCH)[
            :S2S_GRAD_ROWS])


def _summary_counts(out, tag):
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith(tag + " "))[len(tag) + 1:])


def bf16_seq2seq(tmp):
    """17(f): seq2seq with its encoder self-attention block at full width
    (``S2S_ATT``: 30000/512/512, 4 heads of 128, batch 50 of 10-50 words)
    with ``--compute_dtype bfloat16``: --job train (4 batches x 1 pass,
    Adam(5e-4)) and --job test. The block's flash on the bf16 forms
    (``flash_fwd_bf16`` and ``flash_bwd_bf16`` once a step; ``flash_fwd_
    bf16`` in the test), the encoder's GRUs on the f32 sequence kernels
    (the block's output is f32), the decoder's GRU cell on its f32 kernel
    one device launch a call (the group widens its bf16 weights once a
    forward; ``widen_casts`` reports the casts a call makes), Adam once a
    step; the masters and slots f32; the first step's gradients card
    against the CPU plain bf16 path (``_bf16_grads``)."""
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    from paddle_tpu_torch.optim import Adam
    conf = os.path.join(tmp, "bf16_s2s_conf.py")
    _write_s2s_config(conf, S2S_ATT)
    save_dir = os.path.join(tmp, "bf16_s2s_ckpt")
    bf = ["--compute_dtype", "bfloat16"]
    costs, summary = _train_run(conf, 1, save_dir, batches=S2S_BATCHES,
                                extra=bf)
    if not all(np.isfinite(costs)):
        raise AssertionError(f"bf16 seq2seq pass costs {costs}")
    steps = summary["steps"]
    counts = summary["kernels"]
    _bf16_counts("bf16 seq2seq --job train", counts, {
        "flash_fwd_bf16": steps, "flash_bwd_bf16": steps, "flash_fwd": 0,
        "flash_bwd": 0, "gru_seq_train": 2 * steps, "gru_seq_train_bf16": 0,
        "gru_bwd_chain": 2 * steps, "gru_bwd_step": 0, "adam": steps})
    if counts["gru_cell"]["launches"] <= 0:
        raise AssertionError(f"bf16 seq2seq: no gru_cell launch {counts}")
    _check_cell_route("bf16 seq2seq", counts["gru_cell"], "gru_cell")
    n_params, n_slots = _f32_masters(save_dir)
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir, *bf])
    test_line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    test_counts = _summary_counts(out, "test_summary")["kernels"]
    if not np.isfinite(float(test_line.split("cost=")[1].split()[0])) or \
            test_counts["flash_fwd_bf16"]["launches"] <= 0 or \
            test_counts["gru_cell_infer"]["launches"] <= 0:
        raise AssertionError(f"bf16 seq2seq --job test: {test_line}, "
                             f"{test_counts}")
    _check_cell_route("bf16 seq2seq test", test_counts["gru_cell_infer"],
                      "gru_cell_infer")
    grads = _bf16_grads("bf16_seq2seq_grads",
                        lambda: seq2seq_attention(**S2S_ATT),
                        _s2s_bf16_rows(), Adam(learning_rate=5e-4),
                        S2S_GRAD_ROWS)
    return dict(pass_costs=costs, steps=steps,
                median_step_ms=summary["median_step_ms"], kernels=counts,
                widen_casts_a_call=counts["gru_cell"]["widen_casts"]
                / max(counts["gru_cell"]["launches"], 1),
                f32_parameters=n_params, f32_slots=n_slots, test=test_line,
                test_kernels=test_counts, grad_check=grads)


def _write_lcrf_config(path):
    C = LCRF["labels"]
    with open(path, "w") as f:
        f.write(textwrap.dedent("""
            import numpy as np
            from paddle_tpu_torch.config import dsl
            from paddle_tpu_torch.config.model_config import ParamAttr
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import (
                integer_value_sequence, sparse_binary_vector_sequence)
            from paddle_tpu_torch.optim import Adam
        """) + _LINEAR_CRF + textwrap.dedent(f"""

            cost, decoded, chunk = linear_crf(dsl, ParamAttr)
            dsl.evaluator("sum", decoded, name="error")
            dsl.evaluator("chunk", decoded, label=chunk, name="chunk_f1",
                          chunk_scheme="IOB", num_chunk_types={(C - 1) // 2})
            optimizer = Adam(learning_rate=1e-2)
            feeding = DataFeeder(
                {{"features": sparse_binary_vector_sequence(
                      {LCRF['features']}),
                  "chunk": integer_value_sequence({C})}},
                pad_multiple={LCRF_MAX_LEN})

            def train_reader():
                rng = np.random.default_rng({SEED})
                for _ in range({LCRF_BATCHES}):
                    yield sentences(rng, {LCRF_BATCH})

            def test_reader():
                rng = np.random.default_rng({SEED + 2})
                for _ in range({LCRF_TEST_BATCHES}):
                    yield sentences(rng, {LCRF_BATCH})
        """))


def _lcrf_ns():
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.model_config import ParamAttr
    ns = {"np": np}
    exec(_LINEAR_CRF, ns)
    return ns, lambda: ns["linear_crf"](dsl, ParamAttr)


def _lcrf_feed(batch):
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value_sequence,
                                             sparse_binary_vector_sequence)
    return DataFeeder(
        {"features": sparse_binary_vector_sequence(LCRF["features"]),
         "chunk": integer_value_sequence(LCRF["labels"])},
        pad_multiple=LCRF_MAX_LEN, device="cpu")(batch)


def _lcrf_paths(build_model, params, feed):
    """The decode of ``feed`` from ``params`` three ways: the card at
    bf16, the CPU at bf16 and at f32 (the plain path): {key: [B, T] ids},
    and the mask."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost, decoded, _ = build_model()
    net = Network(dsl.current_graph(), outputs=[decoded.name])
    paths = {}
    for key, device, dt in (("cuda", "cuda", "bfloat16"),
                            ("cpu", "cpu", "bfloat16"),
                            ("cpu_f32", "cpu", None)):
        # the trainer's casts and placement, the decode's network
        tr = SGD(cost, parameters=params, device=device,
                 update_equation=Adam(), compute_dtype=dt)
        with torch.no_grad():
            outs = net.apply(tr._cast_compute(tr.params),
                             tr._cast_compute(tr._to_device(feed)))
        paths[key] = outs[decoded.name].state["ids"].cpu()
    return paths, feed["features"].mask.cpu()


def bf16_linear_crf(tmp):
    """17(g): the linear-CRF tagger (``_LINEAR_CRF``: 76,328 sparse
    features, an fc to 23 labels without bias, ``crf_layer`` and
    ``crf_decoding_layer`` sharing ``crfw``) with ``--compute_dtype
    bfloat16``: --job train (4 batches x 1 pass of 16 sentences, Adam)
    and --job test. The CRF on its bf16 forms (``crf_alpha_fwd_bf16``,
    ``crf_bwd_bf16`` once a step, ``crf_viterbi_bf16`` once a step for
    the labelled decode and in the test), no f32 CRF launch, Adam once a
    step; the masters f32; the first step's gradients card against the
    CPU plain bf16 path (``_bf16_grads``); the trained model's decode of
    a test batch on the card against the CPU's at bf16, every parting
    counted, and each sequence where they part one whose CPU f32 and bf16
    decodes part too (a tie that bf16 splits either way)."""
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    conf = os.path.join(tmp, "bf16_lcrf_conf.py")
    _write_lcrf_config(conf)
    save_dir = os.path.join(tmp, "bf16_lcrf_ckpt")
    bf = ["--compute_dtype", "bfloat16"]
    costs, summary = _train_run(conf, 1, save_dir, batches=LCRF_BATCHES,
                                extra=bf)
    if not all(np.isfinite(costs)):
        raise AssertionError(f"bf16 linear CRF pass costs {costs}")
    steps = summary["steps"]
    counts = summary["kernels"]
    _bf16_counts("bf16 linear CRF --job train", counts, {
        "crf_alpha_fwd_bf16": steps, "crf_bwd_bf16": steps,
        "crf_viterbi_bf16": steps, "crf_alpha_fwd": 0, "crf_bwd": 0,
        "crf_viterbi": 0, "adam": steps})
    n_params, n_slots = _f32_masters(save_dir)
    out = _cli_inproc(["--config", conf, "--job", "test", "--save_dir",
                       save_dir, *bf])
    test_line = next(ln for ln in out.splitlines() if ln.startswith("Test: "))
    test_counts = _summary_counts(out, "test_summary")["kernels"]
    _bf16_counts("bf16 linear CRF --job test", test_counts, {
        "crf_alpha_fwd_bf16": LCRF_TEST_BATCHES,
        "crf_viterbi_bf16": LCRF_TEST_BATCHES, "crf_bwd_bf16": 0,
        "crf_viterbi": 0})
    ns, build_model = _lcrf_ns()
    first = ns["sentences"](np.random.default_rng(SEED), LCRF_BATCH)
    grads = _bf16_grads("bf16_linear_crf_grads", build_model,
                        _lcrf_feed(first[:LCRF_GRAD_ROWS]),
                        Adam(learning_rate=1e-2), LCRF_GRAD_ROWS)
    params, _ = load_params(latest_checkpoint(save_dir))
    paths, mask = _lcrf_paths(build_model, params, _lcrf_feed(
        ns["sentences"](np.random.default_rng(SEED + 2), LCRF_BATCH)))
    live = mask > 0
    part = (paths["cuda"] != paths["cpu"]) & live
    own = ((paths["cpu_f32"] != paths["cpu"]) & live).any(dim=1)
    rows = part.any(dim=1)
    decode = dict(steps=int(live.sum()), partings=int(part.sum()),
                  sequences_parted=int(rows.sum()),
                  cpu_f32_bf16_partings=int(((paths["cpu_f32"]
                                              != paths["cpu"]) & live).sum()),
                  parted_outside_ties=int((rows & ~own).sum()))
    phase("bf16_linear_crf_decode", **decode)
    if decode["parted_outside_ties"]:
        raise AssertionError(f"bf16 linear CRF decode: {decode}")
    return dict(pass_costs=costs, steps=steps,
                median_step_ms=summary["median_step_ms"], kernels=counts,
                f32_parameters=n_params, f32_slots=n_slots, test=test_line,
                test_kernels=test_counts, grad_check=grads, decode=decode)


def check_bf16(tmp, f32_traces=(None, None)):
    """Phase 17: mixed-precision training (see the module note).
    ``f32_traces``: the same run's f32 step traces of the classifier and
    the acoustic model (phases 8 and 11c), else taken here."""
    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    lstm_rows = part("lstm_kernels", lambda: [
        check_bf16_lstm(B, H, T, seed=B + 17, timed=i == 0)
        for i, (B, H, T) in enumerate(BF16_LSTM_SHAPES)])
    gru_rows = part("gru_kernels", lambda: [
        check_bf16_gru(B, H, T, rev, seed=B + 19, timed=i == 0)
        for i, (B, H, T, rev) in enumerate(BF16_GRU_SHAPES)])
    flash_rows = part("flash_kernels", lambda: [
        check_bf16_flash(*shape, seed=i + 23, timed=i == 0)
        for i, shape in enumerate(BF16_FLASH_SHAPES)])
    flash_long = part("flash_long", lambda: [
        check_bf16_flash(*shape, seed=i + 31, timed=True)
        for i, shape in enumerate(BF16_FLASH_LONG)])
    crf_rows = part("crf_kernels", lambda: [
        check_bf16_crf(B, T, C, seed=B + T + 29, timed=i == 0)
        for i, (B, T, C) in enumerate(BF16_CRF_SHAPES)])
    phase("bf16_kernels", lstm=lstm_rows, gru=gru_rows, flash=flash_rows,
          flash_long=flash_long, crf=crf_rows)
    classifier = part("classifier", bf16_classifier, tmp, f32_traces[0])
    acoustic = part("acoustic", bf16_acoustic, tmp, f32_traces[1])
    seq2seq = part("seq2seq", bf16_seq2seq, tmp)
    linear_crf = part("linear_crf", bf16_linear_crf, tmp)
    refused = part("refusals", bf16_refusals)
    row = dict(lstm_shapes=lstm_rows, gru_shapes=gru_rows,
               flash_shapes=flash_rows, flash_long=flash_long,
               crf_shapes=crf_rows,
               classifier=classifier, acoustic=acoustic, seq2seq=seq2seq,
               linear_crf=linear_crf, refused=refused,
               part_seconds=parts, seconds=time.perf_counter() - t0)
    brief = lambda r: {k: r[k] for k in ("pass_costs", "steps",
                                         "median_step_ms")}
    trace = lambda r: {dt: {k: t[k] for k in (
        "step_ms", "device_busy_ms", "device_idle_share", "top_kernels",
        "complete")} for dt, t in r["step_trace"].items()}
    phase("bf16", seconds=row["seconds"], part_seconds=parts,
          classifier=brief(classifier),
          classifier_trace=trace(classifier), acoustic=brief(acoustic),
          acoustic_trace=trace(acoustic), seq2seq=brief(seq2seq),
          linear_crf=brief(linear_crf), refused=sorted(refused))
    return row


def bf16():
    """``--bf16``: phase 17 alone; its row in ``bf16.json`` in
    ``OUT_DIR``."""
    build.build_all(["lstm_seq", "gru_seq", "opt_update", "ctc", "crf",
                     "flash_attn", "gru_cell", "lstm_cell"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        row = check_bf16(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "bf16.json"), "w") as f:
        json.dump(row, f, indent=1)
    return row


def _bf16_entries(row):
    """K1-K4's bf16 forms in the kernels line: the launches of phase 17's
    runs (the classifier's train, test and time jobs; the acoustic
    model's train and test), the times at the path's shapes."""
    lstm_src = "paddle_tpu_torch/csrc/lstm_seq.cu"
    gru_src = "paddle_tpu_torch/csrc/gru_seq.cu"
    cl, ac = row["classifier"], row["acoustic"]
    l_row, g_row = row["lstm_shapes"][0], row["gru_shapes"][0]
    l_err = lambda k: max(r[k] for r in row["lstm_shapes"])
    g_err = lambda k: max(r[k] for r in row["gru_shapes"])

    def entry(name, src, replaces, launches, err, r, key, path):
        return dict(_entry(name, src, replaces, launches, err, r, key),
                    shape={k: r[k] for k in ("B", "H", "T")},
                    device_ms=r[key + "device_ms"],
                    f32_ms=r[key + "f32_ms"],
                    f32_device_ms=r[key + "f32_device_ms"],
                    dtype="bfloat16", kernel_route="persistent", path=path,
                    library="none: nn.LSTM has no peepholes" if "lstm" in name
                    else "none: nn.GRU applies its reset gate after the "
                         "product")

    flash_src = "paddle_tpu_torch/csrc/flash_attn.cu"
    crf_src = "paddle_tpu_torch/csrc/crf.cu"
    s2s, lcrf = row["seq2seq"], row["linear_crf"]
    f_row, c_row = row["flash_shapes"][0], row["crf_shapes"][0]
    f_err = lambda k: max(r[k] for r in row["flash_shapes"])  # noqa: E731
    c_err = lambda k: max(r[k] for r in row["crf_shapes"])  # noqa: E731

    def entry2(name, src, replaces, launches, err, r, key, path, **more):
        shape = {k: r[k] for k in ("B", "N", "Tq", "Tk", "D", "T", "C")
                 if k in r}
        return dict(_entry(name, src, replaces, launches, err, r, key),
                    shape=shape, device_ms=r[key + "device_ms"],
                    f32_ms=r[key + "f32_ms"],
                    f32_device_ms=r[key + "f32_device_ms"],
                    dtype="bfloat16", path=path, **more)

    new = [
        entry2("flash_fwd_bf16", flash_src,
               "paddle_tpu/ops/attention.py:107 (_flash_kernel at bf16)",
               s2s["kernels"]["flash_fwd_bf16"]["launches"]
               + s2s["test_kernels"]["flash_fwd_bf16"]["launches"],
               f_err("fwd_max_abs_err"), f_row, "fwd_",
               "seq2seq_attention(seq_parallel) --compute_dtype bfloat16 "
               "train and test",
               library=f"scaled_dot_product_attention at bf16 "
                       f"({f_row['library_backend']})",
               library_device_ms=f_row["fwd_library_device_ms"]),
        entry2("flash_bwd_bf16", flash_src,
               "jax.vjp of blockwise_attention at bf16, paddle_tpu/ops/"
               "attention.py:206 (_flash_bwd)",
               s2s["kernels"]["flash_bwd_bf16"]["launches"],
               f_err("bwd_max_abs_err"), f_row, "bwd_",
               "seq2seq_attention(seq_parallel) --compute_dtype bfloat16 "
               "train",
               library=f"scaled_dot_product_attention backward at bf16 "
                       f"({f_row['library_backend']})",
               library_device_ms=f_row["bwd_library_device_ms"]),
        entry2("crf_alpha_fwd_bf16", crf_src,
               "paddle_tpu/ops/crf.py:87 (_crf_kernel at bf16)",
               lcrf["kernels"]["crf_alpha_fwd_bf16"]["launches"]
               + lcrf["test_kernels"]["crf_alpha_fwd_bf16"]["launches"],
               c_err("fwd_max_abs_err"), c_row, "fwd_",
               "linear-CRF tagger --compute_dtype bfloat16 train and test",
               chain_bound_ms=c_row["fwd_chain_bound_ms"]),
        entry2("crf_bwd_bf16", crf_src,
               "JAX lax.scan paddle_tpu/ops/crf.py:158 (_crf_bwd at bf16)",
               lcrf["kernels"]["crf_bwd_bf16"]["launches"],
               c_err("bwd_max_abs_err"), c_row, "bwd_",
               "linear-CRF tagger --compute_dtype bfloat16 train",
               chain_bound_ms=c_row["bwd_chain_bound_ms"]),
        entry2("crf_viterbi_bf16", crf_src,
               "JAX lax.scan paddle_tpu/layers/chain.py:65 (crf_decode at "
               "bf16)",
               lcrf["kernels"]["crf_viterbi_bf16"]["launches"]
               + lcrf["test_kernels"]["crf_viterbi_bf16"]["launches"],
               0.0, c_row, "viterbi_",
               "linear-CRF tagger --compute_dtype bfloat16 train (the "
               "labelled decode) and test",
               chain_bound_ms=c_row["viterbi_chain_bound_ms"]),
    ]
    return new + [
        entry("lstm_seq_bf16", lstm_src,
              "paddle_tpu/ops/lstm.py:45 (lstm_sequence_ref at bf16; the "
              "Pallas sites :145, :287 refuse bf16)",
              cl["test_kernels"]["lstm_seq_bf16"]["launches"]
              + cl["time_kernels"]["lstm_seq_bf16"]["launches"],
              l_err("primal_max_abs_err"), l_row, "primal_",
              "lstm_text_classifier --compute_dtype bfloat16 test and time "
              "(lstm0)"),
        entry("lstm_seq_train_bf16", lstm_src,
              "paddle_tpu/ops/lstm.py:45 (lstm_sequence_ref at bf16; the "
              "Pallas sites :145, :287 refuse bf16)",
              cl["kernels"]["lstm_seq_train_bf16"]["launches"],
              l_err("fwd_max_abs_err"), l_row, "fwd_",
              "lstm_text_classifier --compute_dtype bfloat16 train (lstm0)"),
        entry("lstm_bwd_chain_bf16", lstm_src,
              "jax.vjp of paddle_tpu/ops/lstm.py:45 (lstm_sequence_ref at "
              "bf16)", cl["kernels"]["lstm_bwd_chain_bf16"]["launches"],
              l_err("chain_max_abs_err"), l_row, "chain_",
              "lstm_text_classifier --compute_dtype bfloat16 train (lstm0)"),
        entry("gru_seq_bf16", gru_src,
              "paddle_tpu/ops/gru.py:33 (gru_sequence_ref at bf16; the "
              "Pallas site :109 refuses bf16)",
              ac["test_kernels"]["gru_seq_bf16"]["launches"],
              g_err("primal_max_abs_err"), g_row, "primal_",
              "CTC acoustic model --compute_dtype bfloat16 test (layer 1)"),
        entry("gru_seq_train_bf16", gru_src,
              "paddle_tpu/ops/gru.py:33 (gru_sequence_ref at bf16; the "
              "Pallas site :109 refuses bf16)",
              ac["kernels"]["gru_seq_train_bf16"]["launches"],
              g_err("fwd_max_abs_err"), g_row, "fwd_",
              "CTC acoustic model --compute_dtype bfloat16 train (layer 1, "
              "both directions)"),
        entry("gru_bwd_chain_bf16", gru_src,
              "jax.vjp of paddle_tpu/ops/gru.py:33 (gru_sequence_ref at "
              "bf16)", ac["kernels"]["gru_bwd_chain_bf16"]["launches"],
              g_err("chain_max_abs_err"), g_row, "chain_",
              "CTC acoustic model --compute_dtype bfloat16 train (layer 1, "
              "both directions)"),
    ]


def _opt_keys(row):
    """The grouped optimizer kernel's list and its other times for its
    entry."""
    return dict(shape={"tensors": row["tensors"],
                       "elements": row["elements"]},
                path=f"{row['path']} step update (one launch a step)",
                kernel_route="multi-tensor",
                table_capacity=row["table_capacity"],
                device_ms=row["device_ms"],
                per_tensor_ms=row["per_tensor_ms"],
                per_tensor_device_ms=row["per_tensor_device_ms"],
                per_tensor_max_abs_err=row["per_tensor_max_abs_err"],
                b2b_ms=row["b2b_ms"], library_b2b_ms=row["library_b2b_ms"])


def _crf_keys(row, split, kind):
    """The CRF backward's or Viterbi's further keys in the kernels line:
    the shape, CUDA events around a call, the chain bound, the earlier
    kernel's device and event times, the host path today and before."""
    return dict(shape={k: row[k] for k in ("B", "T", "C")},
                call_ms=row[f"{kind}_call_ms"],
                chain_bound_ms=row[f"{kind}_chain_bound_ms"],
                before_ms=row[f"{kind}_before_ms"],
                before_call_ms=row[f"{kind}_before_call_ms"],
                host_us=split[f"host_us_{kind}_now"]["whole"],
                host_us_before=split[f"host_us_{kind}_baseline"]["whole"])


def _entry(name, source, replaces, launches, err, row, prefix=""):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row[prefix + "ms"], "plain_ms": row[prefix + "plain_ms"],
            "bound_ms": row[prefix + "bound_ms"],
            "bound_by": row[prefix + "bound_by"],
            "library_ms": row.get(prefix + "library_ms"), "check": "pass"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ds2-rate-witness", action="store_true",
                        help="only train the acoustic model at DS2's rate "
                        "on the card and on the CPU plain path")
    parser.add_argument("--lstm-kernels", action="store_true",
                        help="only phases 3 and 4 for the LSTM at the "
                        "classifier's and the tagger's shapes")
    parser.add_argument("--cell-kernels", action="store_true",
                        help="only phases 5 and 5b for the GRU and LSTM "
                        "cells (both GRU-cell routes, the host splits)")
    parser.add_argument("--flash-kernels", action="store_true",
                        help="only phase 7 for the flash-attention kernels "
                        "(every FLASH_SHAPES row, SDPA beside them)")
    parser.add_argument("--opt-kernels", action="store_true",
                        help="only phase 4's optimizer part (the grouped "
                        "Momentum and Adam kernels at every path's list, "
                        "torch._fused_adam_ beside them, the host split)")
    parser.add_argument("--crf-kernels", action="store_true",
                        help="only phase 6's CRF part (every CRF_SHAPES and "
                        "CRF_BIG_SHAPES row, the chain floor, the earlier "
                        "kernels beside the new, the host split)")
    parser.add_argument("--image", action="store_true",
                        help="only phase 12, the image slice (ResNet-50 at "
                        "entry()'s shape, its training check, LeNet)")
    parser.add_argument("--training", action="store_true",
                        help="only phase 13, the rest of training (gradient "
                        "accumulation, prev_batch_state, async loading, "
                        "kill and resume, dropout, evaluators, the jobs)")
    parser.add_argument("--layers", action="store_true",
                        help="only phase 14, the layer plane (DeepSpeech2 "
                        "as released, both branches; the CTC kernels at its "
                        "shape; every newly ported layer type card against "
                        "CPU)")
    parser.add_argument("--last-types", action="store_true",
                        help="only phase 15, the last layer types (the "
                        "nested GRU text model, word2vec with hsigmoid and "
                        "nce, SSD300's head, the VAE, moe)")
    parser.add_argument("--serving", action="store_true",
                        help="only phase 16, the serving tier (continuous "
                        "batching against convoy, the bf16 and int8 tiers "
                        "with their gate, int8 generation), after one "
                        "training pass of the classifier and of seq2seq")
    parser.add_argument("--bf16", action="store_true",
                        help="only phase 17, mixed-precision training (the "
                        "bf16 forms of the LSTM and GRU sequence kernels, "
                        "of flash and of the CRF; the classifier, the "
                        "acoustic model, seq2seq with its attention block "
                        "and the linear-CRF tagger at --compute_dtype "
                        "bfloat16; the refusals)")
    parser.add_argument("--ctc-kernels", action="store_true",
                        help="only phase 6b for the CTC kernels (both "
                        "operand forms at every CTC_SHAPES row, F.ctc_loss "
                        "beside them, the chain floor, the host split)")
    args = parser.parse_args()
    t_start = time.perf_counter()
    check_device()
    if args.ds2_rate_witness:
        build.build_all(["gru_seq", "opt_update", "ctc"])
        ds2_rate_witness()
        return 0
    if args.lstm_kernels:
        lstm_kernels()
        return 0
    if args.cell_kernels:
        cell_kernels()
        return 0
    if args.flash_kernels:
        flash_kernels()
        return 0
    if args.crf_kernels:
        crf_kernels()
        return 0
    if args.ctc_kernels:
        ctc_kernels()
        return 0
    if args.opt_kernels:
        opt_kernels()
        return 0
    if args.image:
        image_slice()
        return 0
    if args.training:
        training()
        return 0
    if args.layers:
        layers()
        return 0
    if args.last_types:
        last_types()
        return 0
    if args.serving:
        serving()
        return 0
    if args.bf16:
        bf16()
        return 0
    seconds = {}  # each phase's wall time

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        phase("done", name=name, seconds=seconds[name],
              total=time.perf_counter() - t_start)
        return out

    timed("build", build_kernels)
    rows, serve_rows = timed("lstm_kernels", check_kernels)
    train_rows, reverse_err, opt_rows = timed("train_kernels",
                                              check_train_kernels)
    gru_rows, cell_rows = timed("gru_kernels", check_gru_kernels)
    lstm_cell_rows = timed("lstm_cells", check_lstm_cells)
    crf_rows = timed("crf_kernels", check_crf_kernels)
    crf_split = timed("crf_host_split", check_crf_host_split)
    tag_lstm_rows = timed("tagger_lstm_kernels", check_tagger_lstm_kernels)
    ctc_rows = timed("ctc_kernels", check_ctc_kernels)
    ctc_beyond = timed("ctc_beyond", check_ctc_beyond_shapes)
    ctc_gathered = timed("ctc_gathered_beyond",
                         check_ctc_gathered_beyond_shapes)
    ctc_split = timed("ctc_host_split", check_ctc_host_split)
    flash_rows = timed("flash_kernels", check_flash_kernels)
    wide_layer = timed("flash_wide_layer", check_wide_attention_layers,
                       WIDE_LAYER_FULL_REPEATS)
    flash_split = timed("flash_host_split", check_flash_host_split)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        trained, conf, model = timed("train", train, tmp)
        served = timed("serve", serve, tmp, conf, model)
        s2s, s2s_dir = timed("seq2seq", train_seq2seq, tmp, S2S,
                             "seq2seq_train")
        gen_served = timed("seq2seq_serve", serve_generation, tmp, s2s_dir)
        s2s_att, _ = timed("seq2seq_attention", train_seq2seq, tmp, S2S_ATT,
                           "seq2seq_attention_train",
                           ("flash_fwd", "flash_bwd"), ("flash_fwd",))
        lstm_dec = timed("lstm_decoder", lstm_decoder_path, tmp)
        tagger, tag_conf, tag_model = timed("tagger", train_tagger, tmp)
        tag_served = timed("tagger_serve", serve_tagger, tmp, tag_conf,
                           tag_model)
        acoustic = timed("acoustic", train_acoustic, tmp)
        # phase 17 after the paths it runs at bf16 (8, 11c), beside their
        # f32 traces
        bf16_row = timed("bf16", check_bf16, tmp,
                         (trained["step_trace"], acoustic["step_trace"]))
        image = timed("image", check_image, tmp)
        training_row = timed("training", check_training, tmp,
                             trained["pass_costs"])
        layers_row = timed("layers", check_layers, tmp,
                           _ds2r_ctc_row(ctc_rows))
        last_row = timed("last_types", check_last_types)
        # phase 16: the serving tier on phase 8's and phase 10's files
        serve_row = timed("serving_tier", serving_tier, tmp, s2s_dir, conf,
                          os.path.join(tmp, "ckpt"), model)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main_row = serve_rows[-1]  # the largest shape the serving path runs
    # the training path's shape: batch 64 at h=1280, T=100
    t_row = next(r for r in train_rows
                 if (r["B"], r["H"]) == (TRAIN_BATCH, MODEL["hidden"]))
    # the seq2seq path's shapes: batch 50 at h=512, T=50
    g_row = next(r for r in gru_rows
                 if (r["B"], r["H"], r["T"]) == (S2S_BATCH, S2S["hidden"],
                                                 S2S_LEN))
    c_row = next(r for r in cell_rows if r["B"] == S2S_BATCH)
    # the beam search's rows: 8 sources x beam 4
    gen_row = next(r for r in cell_rows
                   if r["B"] == GEN_SOURCES * GEN_BEAM)
    # the acoustic model's GRU shape: batch 16 at h=1024, T=400
    a_row = next(r for r in gru_rows
                 if (r["B"], r["H"], r["T"]) == (DS2_BATCH, DS2["hidden"],
                                                 DS2_MAX_T))
    ctc_row = ctc_rows[0]  # the acoustic model's shape
    ctc_src = "paddle_tpu_torch/csrc/ctc.cu"
    ac_counts, ac_test = acoustic["kernels"], acoustic["test_kernels"]
    # phase 14's DeepSpeech2 as released (its --job train's counts) and
    # its CTC shape (16, 134, S)
    ds2r_counts = layers_row["ds2_release"]["kernels"]
    _check_last_launches(last_row)
    last = last_row["launches"]
    tier = serve_row["launches"]
    ds2r_ctc = layers_row["ctc_shape"]
    ctc_lib = ", ".join(ctc_row["library_kernels"])
    lstm_src = "paddle_tpu_torch/csrc/lstm_seq.cu"
    gru_src = "paddle_tpu_torch/csrc/gru_seq.cu"
    gru_cell_src = "paddle_tpu_torch/csrc/gru_cell.cu"
    opt_src = "paddle_tpu_torch/csrc/opt_update.cu"
    crf_src = "paddle_tpu_torch/csrc/crf.cu"
    flash_src = "paddle_tpu_torch/csrc/flash_attn.cu"
    lstm_cell_src = "paddle_tpu_torch/csrc/lstm_cell.cu"
    # the LSTM cell's shapes: the decoder's training batch, its decode
    lc_train = next(r for r in lstm_cell_rows if r["B"] == S2S_BATCH)
    lc_decode = next(r for r in lstm_cell_rows
                     if r["B"] == GEN_SOURCES * GEN_BEAM)
    lc_err = max(r["max_abs_err"] for r in lstm_cell_rows)
    att_counts, att_test = s2s_att["kernels"], s2s_att["test_kernels"]
    f_row = flash_rows[0]  # the attention seq2seq path's shape
    tc_rows = [r for r in flash_rows if r["path"] == "tensor_cores"]
    wide_rows = [r for r in flash_rows if r["path"] == "wide"]
    w_row = wide_rows[0]  # D = 256, the wide layer's head width
    split_rows = [r for r in flash_rows if r["path"] == "split"]
    s_row = split_rows[0]  # D = 1056
    ctc_wide = next(r for r in ctc_beyond if r["plan"]["fwd"] == "wide")
    ctc_sorted = next(r for r in ctc_beyond if r["plan"]["bwd"] == "sorted")
    counts = trained["kernels"]
    s2s_counts, s2s_test = s2s["kernels"], s2s["test_kernels"]
    tag_counts, tag_test = tagger["kernels"], tagger["test_kernels"]
    crf_row = crf_rows[0]  # the training path's shape
    crf_err = {k: max(r[f"{k}_max_abs_err"] for r in crf_rows
                      if f"{k}_max_abs_err" in r) for k in ("fwd", "bwd")}
    gru_fwd_err = max(r["fwd_max_abs_err"] for r in gru_rows)
    gru_bwd_err = max(r["bwd_max_abs_err"] for r in gru_rows)
    cell_err = max(r["max_abs_err"] for r in cell_rows)
    # the tagger's LSTM runs at H=128, where the JAX package takes the
    # resident-weight _lstm_kernel: its own entries, with the tagger's
    # launches and the times at the tagger's shapes
    tag_p_row = tag_lstm_rows["primal"][0]  # the test pass's (64, 128, 80)
    tag_t_row = tag_lstm_rows["train"]
    entries = [
        dict(_entry("lstm_seq", lstm_src, "paddle_tpu/ops/lstm.py:174",
                    served["launches"] + tier["lstm_seq"],
                    max(r["max_abs_err"] for r in rows + serve_rows),
                    main_row),
             shape={k: main_row[k] for k in ("B", "H", "T")},
             **_lstm_route_keys(main_row, ""),
             training_launches=training_row["launches"]["lstm_seq"],
             serving_tier_launches=tier["lstm_seq"],
             path="lstm_text_classifier serve; its fp32, bf16 and int8 "
                  "tiers (phase 16b)"),
        dict(_entry("lstm_seq_train", lstm_src, "paddle_tpu/ops/lstm.py:174",
                    counts["lstm_seq_train"]["launches"],
                    max(r["fwd_max_abs_err"] for r in train_rows), t_row,
                    "fwd_"),
             shape={k: t_row[k] for k in ("B", "H", "T")},
             **_lstm_route_keys(t_row, "fwd_"),
             training_launches=training_row["launches"]["lstm_seq_train"],
             path="lstm_text_classifier train"),
        dict(_entry("lstm_bwd_chain", lstm_src,
                    "JAX lax.scan paddle_tpu/ops/lstm.py:358 (_bwd_rule)",
                    counts["lstm_bwd_chain"]["launches"],
                    max([r["bwd_max_abs_err"] for r in train_rows]
                        + [reverse_err]), t_row, "chain_"),
             shape={k: t_row[k] for k in ("B", "H", "T")},
             **_lstm_chain_keys(t_row),
             training_launches=training_row["launches"]["lstm_bwd_chain"],
             path="lstm_text_classifier train"),
        dict(_entry("lstm_bwd_step", lstm_src,
                    "JAX lax.scan paddle_tpu/ops/lstm.py:358 (_bwd_rule)",
                    counts["lstm_bwd_step"]["launches"],
                    max([r["bwd_max_abs_err"] for r in train_rows]
                        + [reverse_err]), t_row, "step_"),
             shape={"B": t_row["B"], "H": t_row["H"], "T": 1},
             on_path=False, kernel_route="per-step",
             path="none: the per-step route's backward (H above the route "
                  "line); timed here at the classifier's shape"),
        dict(_entry("lstm_seq_h128", lstm_src, "paddle_tpu/ops/lstm.py:73",
                    tag_test["lstm_seq"]["launches"]
                    + tag_served["lstm_seq_launches"],
                    max(r["max_abs_err"] for r in tag_lstm_rows["primal"]),
                    tag_p_row),
             shape={k: tag_p_row[k] for k in ("B", "H", "T")},
             **_lstm_route_keys(tag_p_row, ""),
             path="bilstm_crf_tagger test and serve"),
        dict(_entry("lstm_seq_train_h128", lstm_src,
                    "paddle_tpu/ops/lstm.py:73",
                    tag_counts["lstm_seq_train"]["launches"],
                    tag_t_row["fwd_max_abs_err"], tag_t_row, "fwd_"),
             shape={k: tag_t_row[k] for k in ("B", "H", "T")},
             **_lstm_route_keys(tag_t_row, "fwd_"),
             path="bilstm_crf_tagger train"),
        dict(_entry("lstm_bwd_chain_h128", lstm_src,
                    "JAX lax.scan paddle_tpu/ops/lstm.py:358 (_bwd_rule)",
                    tag_counts["lstm_bwd_chain"]["launches"],
                    tag_t_row["bwd_max_abs_err"], tag_t_row, "chain_"),
             shape={k: tag_t_row[k] for k in ("B", "H", "T")},
             **_lstm_chain_keys(tag_t_row), path="bilstm_crf_tagger train"),
        dict(_entry("lstm_bwd_step_h128", lstm_src,
                    "JAX lax.scan paddle_tpu/ops/lstm.py:358 (_bwd_rule)",
                    tag_counts["lstm_bwd_step"]["launches"],
                    tag_t_row["bwd_max_abs_err"], tag_t_row, "step_"),
             shape={"B": tag_t_row["B"], "H": tag_t_row["H"], "T": 1},
             on_path=False, kernel_route="per-step",
             path="none: the per-step route's backward (H above the route "
                  "line); timed here at the tagger's shape"),
        dict(_entry("gru_seq", gru_src, "paddle_tpu/ops/gru.py:57",
                    s2s_test["gru_seq"]["launches"] + tier["gru_seq"],
                    gru_fwd_err, g_row),
             shape={k: g_row[k] for k in ("B", "H", "T")},
             two_launch_ms=g_row["two_launch_ms"], kernel_route="persistent",
             serving_tier_launches=tier["gru_seq"],
             path="seq2seq_attention test; the encoder at each admission "
                  "and convoy batch (phase 16a, c)"),
        dict(_entry("gru_seq_train", gru_src, "paddle_tpu/ops/gru.py:57",
                    s2s_counts["gru_seq_train"]["launches"], gru_fwd_err,
                    g_row, "train_"),
             shape={k: g_row[k] for k in ("B", "H", "T")},
             device_ms=g_row["train_device_ms"],
             two_launch_ms=g_row["two_launch_train_ms"],
             two_launch_device_ms=g_row["two_launch_train_device_ms"],
             kernel_route="persistent"),
        dict(_entry("gru_bwd_chain", gru_src,
                    "JAX lax.scan paddle_tpu/ops/gru.py:135 (_bwd_rule)",
                    s2s_counts["gru_bwd_chain"]["launches"], gru_bwd_err,
                    g_row, "chain_"),
             shape={k: g_row[k] for k in ("B", "H", "T")},
             device_ms=g_row["chain_device_ms"],
             step_loop_ms=g_row["step_loop_ms"],
             backward_ms=g_row["bwd_ms"],
             two_launch_backward_ms=g_row["two_launch_bwd_ms"],
             kernel_route="persistent"),
        dict(_entry("gru_bwd_step", gru_src,
                    "JAX lax.scan paddle_tpu/ops/gru.py:135 (_bwd_rule)",
                    s2s_counts["gru_bwd_step"]["launches"], gru_bwd_err,
                    g_row, "step_"),
             shape={"B": g_row["B"], "H": g_row["H"], "T": 1},
             on_path=False, kernel_route="two-launch",
             path="none: the two-launch route's backward (H above the "
                  "route line); timed here at the seq2seq shape"),
        dict(_entry("gru_cell", gru_cell_src,
                    "paddle_tpu/kernels/rnn_cells.py:171",
                    s2s_counts["gru_cell"]["launches"] + last["gru_cell"],
                    cell_err, c_row),
             shape={"B": c_row["B"], "H": c_row["H"]},
             **_cell_route_keys(c_row),
             last_types_launches=last["gru_cell"],
             path="seq2seq_attention train; the nested GRU text model "
                  "train (phase 15a)"),
        dict(_entry("gru_cell_infer", gru_cell_src,
                    "paddle_tpu/kernels/rnn_cells.py:171",
                    s2s_test["gru_cell_infer"]["launches"]
                    + gen_served["launches"] + tier["gru_cell_infer"],
                    cell_err, gen_row),
             shape={"B": gen_row["B"], "H": gen_row["H"]},
             **_cell_route_keys(gen_row),
             serving_tier_launches=tier["gru_cell_infer"],
             path="seq2seq_attention test and /v1/generate; a decode "
                  "session's step over its 32 rows (phase 16a, c)"),
        dict(_entry("lstm_cell", lstm_cell_src,
                    "paddle_tpu/kernels/rnn_cells.py:78",
                    lstm_dec["kernels"]["lstm_cell"]["launches"], lc_err,
                    lc_train),
             shape={"B": lc_train["B"], "H": lc_train["H"]},
             device_ms=lc_train["device_ms"],
             library="none: torch's lstm_cell has no peepholes and takes "
                     "its own weight products",
             path="lstm_step decoder train"),
        dict(_entry("lstm_cell_infer", lstm_cell_src,
                    "paddle_tpu/kernels/rnn_cells.py:78",
                    lstm_dec["decode"]["launches"], lc_err, lc_decode),
             shape={"B": lc_decode["B"], "H": lc_decode["H"]},
             device_ms=lc_decode["device_ms"],
             library="none: torch's lstm_cell has no peepholes and takes "
                     "its own weight products",
             path="lstm_step decoder beam search"),
        dict(_entry("momentum", opt_src,
                    "paddle_tpu/kernels/opt_update.py:83",
                    trained["momentum_kernels"]["momentum"]["launches"]
                    + last["momentum"],
                    opt_rows["momentum"]["max_abs_err"], opt_rows["momentum"]),
             **_opt_keys(opt_rows["momentum"]),
             last_types_launches=last["momentum"],
             lenet_launches=image["lenet"]["kernels"]["momentum"]["launches"],
             resnet_launches=image["resnet_train"]["momentum_launches"],
             library="none: torch._fused_sgd_ keeps its buffer in gradient "
                     "units (buf = -mom / lr); Paddle's step needs a "
                     "rescaling pass around it"),
        dict(_entry("adam", opt_src, "paddle_tpu/kernels/opt_update.py:110",
                    counts["adam"]["launches"]
                    + s2s_counts["adam"]["launches"]
                    + tag_counts["adam"]["launches"]
                    + att_counts["adam"]["launches"]
                    + lstm_dec["kernels"]["adam"]["launches"]
                    + ac_counts["adam"]["launches"] + last["adam"],
                    opt_rows["adam"]["max_abs_err"], opt_rows["adam"]),
             **_opt_keys(opt_rows["adam"]),
             last_types_launches=last["adam"],
             training_launches=training_row["launches"]["adam"],
             ds2_release_launches=ds2r_counts["adam"]["launches"],
             library="torch._fused_adam_ (eps / sqrt(1 - beta2^t))"),
        dict(_entry("crf_alpha_fwd", crf_src, "paddle_tpu/ops/crf.py:87",
                    tag_counts["crf_alpha_fwd"]["launches"]
                    + tag_test["crf_alpha_fwd"]["launches"], crf_err["fwd"],
                    crf_row, "fwd_"),
             **_crf_keys(crf_row, crf_split[0], "fwd")),
        dict(_entry("crf_bwd", crf_src,
                    "JAX lax.scan paddle_tpu/ops/crf.py:158 (_crf_bwd)",
                    tag_counts["crf_bwd"]["launches"], crf_err["bwd"],
                    crf_row, "bwd_"),
             **_crf_keys(crf_row, crf_split[0], "bwd")),
        dict(_entry("crf_viterbi", crf_src,
                    "JAX lax.scan paddle_tpu/layers/chain.py:65 (crf_decode)",
                    tag_counts["crf_viterbi"]["launches"]
                    + tag_test["crf_viterbi"]["launches"]
                    + tag_served["launches"],
                    max(r["viterbi_score_err"] for r in crf_rows), crf_row,
                    "viterbi_"),
             **_crf_keys(crf_row, crf_split[0], "viterbi")),
        dict(_entry("flash_fwd", flash_src,
                    "paddle_tpu/ops/attention.py:107",
                    att_counts["flash_fwd"]["launches"]
                    + att_test["flash_fwd"]["launches"],
                    max(r["fwd_max_abs_err"] for r in tc_rows), f_row,
                    "fwd_"),
             shape={k: f_row[k] for k in ("B", "N", "Tq", "Tk", "D")},
             device_ms=f_row["fwd_device_ms"],
             library_device_ms=f_row["fwd_library_device_ms"],
             bound_tf32x3_ms=f_row["fwd_bound_tf32x3_ms"],
             library=f"scaled_dot_product_attention ({f_row['sdpa_backend']})",
             path="seq2seq_attention(seq_parallel) train and test"),
        dict(_entry("flash_bwd", flash_src,
                    "jax.vjp of blockwise_attention, paddle_tpu/ops/"
                    "attention.py:206 (_flash_bwd)",
                    att_counts["flash_bwd"]["launches"],
                    max(r["bwd_max_abs_err"] for r in tc_rows), f_row,
                    "bwd_"),
             shape={k: f_row[k] for k in ("B", "N", "Tq", "Tk", "D")},
             device_ms=f_row["bwd_device_ms"],
             library_device_ms=f_row["bwd_library_device_ms"],
             bound_tf32x3_ms=f_row["bwd_bound_tf32x3_ms"],
             library=f"scaled_dot_product_attention backward "
                     f"({f_row['sdpa_backend']})",
             path="seq2seq_attention(seq_parallel) train"),
        # the wide-head path (D > 128): on no path's shapes; the layer
        # check's multi_head_attention(size=512, num_heads=2) ran it
        dict(_entry("flash_fwd_wide", flash_src,
                    "paddle_tpu/ops/attention.py:107", 0,
                    max(r["fwd_max_abs_err"] for r in wide_rows), w_row,
                    "fwd_"),
             shape={k: w_row[k] for k in ("B", "N", "Tq", "Tk", "D")},
             device_ms=w_row["fwd_device_ms"],
             library_device_ms=w_row["fwd_library_device_ms"],
             bound_tf32x3_ms=w_row["fwd_bound_tf32x3_ms"],
             library=f"scaled_dot_product_attention ({w_row['sdpa_backend']})",
             on_path=False, kernel_route="wide",
             layer_check_launches=wide_layer["flash_launches"][0],
             path="none: no path has a head wider than 128; "
                  "multi_head_attention(size=512, num_heads=2) checked"),
        dict(_entry("flash_bwd_wide", flash_src,
                    "jax.vjp of blockwise_attention, paddle_tpu/ops/"
                    "attention.py:206 (_flash_bwd)", 0,
                    max(r["bwd_max_abs_err"] for r in wide_rows), w_row,
                    "bwd_"),
             shape={k: w_row[k] for k in ("B", "N", "Tq", "Tk", "D")},
             device_ms=w_row["bwd_device_ms"],
             library_device_ms=w_row["bwd_library_device_ms"],
             bound_tf32x3_ms=w_row["bwd_bound_tf32x3_ms"],
             library=f"scaled_dot_product_attention backward "
                     f"({w_row['sdpa_backend']})",
             on_path=False, kernel_route="wide",
             layer_check_launches=wide_layer["flash_launches"][1],
             path="none: no path has a head wider than 128; "
                  "multi_head_attention(size=512, num_heads=2) checked"),
        # the split-row path (D > 1024): on no path's shapes
        dict(_entry("flash_fwd_split", flash_src,
                    "paddle_tpu/ops/attention.py:107", 0,
                    max(r["fwd_max_abs_err"] for r in split_rows), s_row,
                    "fwd_"),
             shape={k: s_row[k] for k in ("B", "N", "Tq", "Tk", "D")},
             device_ms=s_row["fwd_device_ms"],
             library_device_ms=s_row["fwd_library_device_ms"],
             library=f"scaled_dot_product_attention ({s_row['sdpa_backend']})",
             on_path=False, kernel_route="split",
             path="none: no path has a head wider than 1024"),
        dict(_entry("flash_bwd_split", flash_src,
                    "jax.vjp of blockwise_attention, paddle_tpu/ops/"
                    "attention.py:206 (_flash_bwd)", 0,
                    max(r["bwd_max_abs_err"] for r in split_rows), s_row,
                    "bwd_"),
             shape={k: s_row[k] for k in ("B", "N", "Tq", "Tk", "D")},
             device_ms=s_row["bwd_device_ms"],
             library_device_ms=s_row["bwd_library_device_ms"],
             library=f"scaled_dot_product_attention backward "
                     f"({s_row['sdpa_backend']})",
             on_path=False, kernel_route="split",
             path="none: no path has a head wider than 1024"),
        dict(_entry("gru_seq_h1024", gru_src, "paddle_tpu/ops/gru.py:57",
                    ac_test["gru_seq"]["launches"], gru_fwd_err, a_row),
             shape={k: a_row[k] for k in ("B", "H", "T")},
             two_launch_ms=a_row["two_launch_ms"], kernel_route="persistent",
             path="CTC acoustic model test"),
        dict(_entry("gru_seq_train_h1024", gru_src,
                    "paddle_tpu/ops/gru.py:57",
                    ac_counts["gru_seq_train"]["launches"], gru_fwd_err,
                    a_row, "train_"),
             shape={k: a_row[k] for k in ("B", "H", "T")},
             device_ms=a_row["train_device_ms"],
             two_launch_ms=a_row["two_launch_train_ms"],
             two_launch_device_ms=a_row["two_launch_train_device_ms"],
             kernel_route="persistent", path="CTC acoustic model train"),
        dict(_entry("gru_bwd_chain_h1024", gru_src,
                    "JAX lax.scan paddle_tpu/ops/gru.py:135 (_bwd_rule)",
                    ac_counts["gru_bwd_chain"]["launches"], gru_bwd_err,
                    a_row, "chain_"),
             shape={k: a_row[k] for k in ("B", "H", "T")},
             device_ms=a_row["chain_device_ms"],
             step_loop_ms=a_row["step_loop_ms"],
             backward_ms=a_row["bwd_ms"],
             two_launch_backward_ms=a_row["two_launch_bwd_ms"],
             kernel_route="persistent", path="CTC acoustic model train"),
        dict(_entry("gru_bwd_step_h1024", gru_src,
                    "JAX lax.scan paddle_tpu/ops/gru.py:135 (_bwd_rule)",
                    ac_counts["gru_bwd_step"]["launches"], gru_bwd_err,
                    a_row, "step_"),
             shape={"B": a_row["B"], "H": a_row["H"], "T": 1},
             on_path=False, kernel_route="two-launch",
             path="none: the two-launch route's backward (H above the "
                  "route line); timed here at the acoustic model's shape"),
        dict(_entry("ctc_fused_fwd", ctc_src, "paddle_tpu/ops/ctc.py:87",
                    ac_counts["ctc_fused_fwd"]["launches"]
                    + ac_test["ctc_fused_fwd"]["launches"],
                    max(r["fused_fwd_max_abs_err"]
                        for r in ctc_rows + [ds2r_ctc]),
                    ctc_row, "fused_fwd_"),
             shape={k: ctc_row[k] for k in ("B", "T", "S")},
             ds2_release_launches=ds2r_counts["ctc_fused_fwd"]["launches"],
             ds2_release_shape={k: ds2r_ctc[k] for k in ("B", "T", "S")},
             ds2_release_ms=ds2r_ctc["fused_fwd_ms"],
             ds2_release_plain_ms=ds2r_ctc["fused_fwd_plain_ms"],
             ds2_release_bound_ms=ds2r_ctc["fused_fwd_bound_ms"],
             ds2_release_library_ms=ds2r_ctc.get("fused_fwd_library_ms"),
             call_ms=ctc_row["fused_fwd_call_ms"],
             nograd_ms=ctc_row["fused_fwd_nograd_ms"],
             nograd_call_ms=ctc_row["fused_fwd_nograd_call_ms"],
             chain_bound_ms=ctc_row["fused_fwd_chain_bound_ms"],
             port_path_ms=ctc_row["fwd_port_path_ms"],
             baseline_path_ms=ctc_row["fwd_baseline_path_ms"],
             library=f"torch.nn.functional.ctc_loss forward ({ctc_lib})",
             path="CTC acoustic model train (alpha and beta chains) and "
                  "test (alpha chains)"),
        dict(_entry("ctc_fused_bwd", ctc_src,
                    "JAX lax.scan paddle_tpu/ops/ctc.py:136 (_ctc_bwd)",
                    ac_counts["ctc_fused_bwd"]["launches"],
                    max(r["fused_bwd_max_abs_err"]
                        for r in ctc_rows + [ds2r_ctc]),
                    ctc_row, "fused_bwd_"),
             shape={k: ctc_row[k] for k in ("B", "T", "S")},
             ds2_release_launches=ds2r_counts["ctc_fused_bwd"]["launches"],
             ds2_release_shape={k: ds2r_ctc[k] for k in ("B", "T", "S")},
             ds2_release_ms=ds2r_ctc["fused_bwd_ms"],
             ds2_release_plain_ms=ds2r_ctc["fused_bwd_plain_ms"],
             ds2_release_bound_ms=ds2r_ctc["fused_bwd_bound_ms"],
             ds2_release_library_ms=ds2r_ctc.get("fused_bwd_library_ms"),
             call_ms=ctc_row["fused_bwd_call_ms"],
             port_path_ms=ctc_row["bwd_port_path_ms"],
             baseline_path_ms=ctc_row["bwd_baseline_path_ms"],
             library=f"torch.nn.functional.ctc_loss backward ({ctc_lib})",
             path="CTC acoustic model train (the posterior pass)"),
        dict(_entry("ctc_alpha_fwd", ctc_src, "paddle_tpu/ops/ctc.py:87",
                    ac_counts["ctc_alpha_fwd"]["launches"]
                    + ac_test["ctc_alpha_fwd"]["launches"],
                    max(r["fwd_max_abs_err"] for r in ctc_rows), ctc_row,
                    "fwd_"),
             shape={k: ctc_row[k] for k in ("B", "T", "S")},
             call_ms=ctc_row["fwd_call_ms"],
             chain_bound_ms=ctc_row["fwd_chain_bound_ms"],
             library=f"torch.nn.functional.ctc_loss forward ({ctc_lib})",
             on_path=False,
             path="none: the gathered form (ops/ctc.py:ctc_ll, JAX's "
                  "operands); timed here at the acoustic model's shape"),
        dict(_entry("ctc_bwd", ctc_src,
                    "JAX lax.scan paddle_tpu/ops/ctc.py:136 (_ctc_bwd)",
                    ac_counts["ctc_bwd"]["launches"],
                    max(r["bwd_max_abs_err"] for r in ctc_rows), ctc_row,
                    "bwd_"),
             shape={k: ctc_row[k] for k in ("B", "T", "S")},
             call_ms=ctc_row["bwd_call_ms"],
             chain_bound_ms=ctc_row["bwd_chain_bound_ms"],
             library=f"torch.nn.functional.ctc_loss backward ({ctc_lib})",
             on_path=False,
             path="none: the gathered form's beta chain; timed here at the "
                  "acoustic model's shape"),
        # the gathered form's wide route (S above 16,384): on no path
        dict(_entry("ctc_alpha_fwd_wide", ctc_src,
                    "paddle_tpu/ops/ctc.py:87", 0,
                    max(r["fwd_max_abs_err"] for r in ctc_gathered),
                    ctc_gathered[-1], "fwd_"),
             shape={k: ctc_gathered[-1][k] for k in ("B", "T", "S")},
             device_ms=ctc_gathered[-1]["fwd_device_ms"],
             library="torch.nn.functional.ctc_loss forward",
             on_path=False, kernel_route="wide",
             path="none: the gathered form above 16,384 states"),
        dict(_entry("ctc_bwd_wide", ctc_src,
                    "JAX lax.scan paddle_tpu/ops/ctc.py:136 (_ctc_bwd)", 0,
                    max(r["bwd_max_abs_err"] for r in ctc_gathered),
                    ctc_gathered[-1], "bwd_"),
             shape={k: ctc_gathered[-1][k] for k in ("B", "T", "S")},
             device_ms=ctc_gathered[-1]["bwd_device_ms"],
             library="torch.nn.functional.ctc_loss backward",
             on_path=False, kernel_route="wide",
             path="none: the gathered form above 16,384 states"),
        # the fused kernels' routes above the lane chains and the staged
        # posterior pass: on no path's shapes
        dict(_entry("ctc_fused_fwd_wide", ctc_src, "paddle_tpu/ops/ctc.py:87",
                    0, ctc_wide["fused_fwd_max_abs_err"], ctc_wide,
                    "fused_fwd_"),
             shape={k: ctc_wide[k] for k in ("B", "T", "C", "S")},
             device_ms=ctc_wide["fused_fwd_device_ms"],
             library="torch.nn.functional.ctc_loss forward",
             on_path=False, kernel_route="wide",
             path="none: no path has more than 16,384 states"),
        dict(_entry("ctc_fused_bwd_sorted", ctc_src,
                    "JAX lax.scan paddle_tpu/ops/ctc.py:136 (_ctc_bwd)", 0,
                    ctc_sorted["fused_bwd_max_abs_err"], ctc_sorted,
                    "fused_bwd_"),
             shape={k: ctc_sorted[k] for k in ("B", "T", "C", "S")},
             device_ms=ctc_sorted["fused_bwd_device_ms"],
             library="torch.nn.functional.ctc_loss backward",
             on_path=False, kernel_route="sorted",
             path="none: no path's classes overflow the staged pass"),
        *_bf16_entries(bf16_row),
    ]
    for e in entries:
        if "ds2_release_launches" in e and e["ds2_release_launches"] <= 0:
            raise AssertionError(f"DeepSpeech2 as released never launched "
                                 f"{e['name']}")
        if "training_launches" in e and e["training_launches"] <= 0:
            raise AssertionError(f"the rest of training never launched "
                                 f"{e['name']}")
        if "serving_tier_launches" in e and e["serving_tier_launches"] <= 0:
            raise AssertionError(f"the serving tier never launched "
                                 f"{e['name']}")
        if e.get("on_path", True) and e["launches"] <= 0:
            raise AssertionError(f"the main path never launched {e['name']}")
        if not e.get("on_path", True) and e["launches"] != 0:
            raise AssertionError(f"{e['name']} is off the route of every "
                                 f"path, yet launched {e['launches']}")
    kernels = {"kernels": entries}
    elapsed = time.perf_counter() - t_start
    phase("elapsed", seconds=elapsed, phases=seconds)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"bench_shapes": rows, "serve_shapes": serve_rows,
                   "train_shapes": train_rows, "reverse_err": reverse_err,
                   "optimizer": opt_rows, "gru_shapes": gru_rows,
                   "gru_cell_shapes": cell_rows,
                   "lstm_cell_shapes": lstm_cell_rows, "crf_shapes": crf_rows,
                   "crf_host_split": crf_split,
                   "tagger_lstm_shapes": tag_lstm_rows,
                   "flash_shapes": flash_rows,
                   "flash_wide_layer": wide_layer,
                   "flash_host_split": flash_split, "ctc_shapes": ctc_rows,
                   "ctc_beyond": ctc_beyond,
                   "ctc_gathered_beyond": ctc_gathered,
                   "ctc_host_split": ctc_split,
                   "image": image,
                   "train": trained, "serve": served, "seq2seq": s2s,
                   "seq2seq_generate_serve": gen_served,
                   "seq2seq_attention": s2s_att, "lstm_decoder": lstm_dec,
                   "tagger": tagger, "tagger_serve": tag_served,
                   "acoustic": acoustic, "training": training_row,
                   "layers": layers_row, "last_types": last_row,
                   "serving_tier": serve_row, "bf16": bf16_row,
                   "elapsed_s": elapsed,
                   "phase_seconds": seconds,
                   **kernels},
                  f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
