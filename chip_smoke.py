#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (generative_audio_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Two models are driven at full width, FullSubNet+ (TCN towers, sub-band LSTM)
and FullSubNet v1 with the GRU body (full-band GRU H=512, sub-band GRU
H=384), each through the serving and the training entry point. Phases, each
of which fails the run (non-zero exit, no result line):
  1. the card (name, power limit, torch and CUDA versions) and the build of
     every CUDA kernel from generative_audio_torch/csrc, with the registers
     ptxas reports for every instance;
  2. the two inference kernels (A and B, cluster scans) against their plain
     PyTorch versions at the serving shape (T=628 frames, H=384, 2056 rows =
     batch 8 x 257 bins, and a ragged row count; forward and reverse), the
     chunked kernel against the unchunked one bit for bit, and each
     kernel's time and microseconds a step beside its bound, its plain
     version's time and a cuDNN LSTM's time, also at 257 rows (one 10 s
     clip), with the launch plan ops.lstm.card_scan_plan picks (cluster
     size, rows per cluster, clusters, the card's occupancy, waves, shared
     bytes) and the instances' registers;
  3. the two training kernels at the training shape (T=195 frames, 2304 rows
     = batch 18 x 128 bins after drop_band, and a ragged row count; forward
     and reverse): the training forward's h against the inference kernel's
     bit for bit, its c sequence and the backward scan's dgates against
     their plain versions, the backward's launch plan (a thread-block
     cluster) against its single-block design bit for bit (and, first, every
     plan of both backward scans at small shapes, scripts/perf_bwd_scan.py),
     the whole LSTMScan gradient against autograd through the float32
     recurrence, and the times (both designs of the backward), plans and
     registers as in phase 2 (the library call is a cuDNN LSTM's forward and
     backward);
  4. the serving path at FullSubNet+'s full width (random weights from a
     numpy seed in the JAX param layout, carried across by
     utils/convert.py), bf16: a 1 s clip against the float32 model on the
     CPU, then three single requests (3 s, 7.5 s, 10 s) and one batched
     enhance_dir of 8 x 10 s clips;
  5. a 30 s request with a lowered gates limit, so the sub-band LSTM takes
     the time-chunked path, against the same request unchunked;
  6. the training path at full width: EnhanceTrainConfig() defaults (batch
     18 x 3.072 s, bf16, Adam 1e-3, clip 10), five steps of EnhanceTrainer
     on one fixed batch of seeded noise, with the launch counts of every
     step, the time per step and the peak memory; then a batch of 4 x 1 s
     whose bf16 loss and gradients on the card are held against the float32
     model on the CPU;
  7. torch.profiler breakdowns by kernel of one batch-8 x 10 s forward and
     of one training step;
  8. the three LSTM scan kernels once more at FullSubNet v1's full-band
     shape (H=512, T=195, 18 rows and 1 row, forward and reverse; the
     backward's cluster against its single block bit for bit), with kernel
     A's and the backward's times (both designs), plans and registers at 18
     rows; then every scan wrapper of the model paths (LSTM forward, carry,
     training forward and backward; GRU forward, carry and backward) and
     the LSTM layer with the projection inside (lstm_layer_tm) at H=100
     and 200, which the wrappers zero-pad to the kernels' units, against its
     plain version; then the single-block forwards (kernel F's route where
     no cluster holds H; the scans' under single_block_forwards()): against
     the clusters bit for bit at LSTM H=512 and GRU H=640, every such
     wrapper at LSTM H=640 and 768 (lstm_layer_tm's lstm_layer_fwd_block
     among them) and GRU H=768 against its plain version, and each scan
     entry's time at H=768; then phases 23 and 24; then LSTMScan at H=768
     and 1024 (kernels C's and D's streamed clusters) against autograd
     through the float32 recurrence;
  9. the GRU forward and carry kernels against their plain versions at the
     sub-band serving shape (T=628, H=384, 2056 rows and a ragged count) and
     the full-band shape (H=512, 8 rows and 1 row), chunked against unchunked
     bit for bit, times beside the bound, the plain version and a cuDNN GRU;
 10. the GRU backward (the scan and the dW_hh contraction) at the training
     shape (T=195, H=384, 2304 rows and a ragged count; H=512, 18 rows):
     the forward as GRUScan launches it, dgates, dW_hh and db_hh against
     their plain versions, the scan's plan (a cluster) against its single
     block bit for bit (dgx, dhn and every db_hh partial), the contraction
     alone against a float32 matmul, GRUScan's three gradients against
     autograd through the float32 recurrence, and the times, the scan's at
     both shapes and in both designs (the library call is a cuDNN GRU's
     forward and backward, and one torch.mm for the contraction);
 11. phases 4-7 again for FullSubNet v1-GRU (mode full_band_crm_mask; model
     type "fullsubnet"), plus the 1 s clip for v1-LSTM;
 12. the LSTM layer and scan variants, each through its own entry point: the
     layer with the projection inside the scan (ops.lstm.lstm_layer_tm) over
     FullSubNet+'s real sub-band stack (the model's layer-1 input of one
     batch-8 x 10 s request, its own weights), against its plain version at
     both layers, forward and reverse, and at a ragged row count, and both
     layers against the model's own hoisted stack; the cluster against its
     single block (lstm_layer_fwd_block, the first design) bit for bit at
     both layers, the ragged count and H=512; LSTMLayerScan's four
     gradients at the training shape against autograd through the float32
     recurrence, with its exact launches; the chains backward
     (scripts.perf_lstm_chains, kernel G, 2 and 4 chains) bit for bit
     against kernel D at the script's shape, the training shape, a ragged
     row count and H=100, 200 (its single block) and 512, and the K-step
     unrolled forward (scripts.perf_lstm_unroll) bit for bit against kernel
     A (also at H=100 and 200, and through its single block at H=640 and
     768 against lstm_scan_fwd_block); and their times beside bound, plain
     version and library (kernel G's beside kernel D's in alternating
     rounds, the layer's beside its single block's), with the plans and
     registers of the staged kernels and of kernel G, and kernel D's
     cluster registers against their recorded counts.
 13. the rest of serving at FullSubNet+'s full width, bf16, phase 4's
     weights: overlapped_chunk (spectral, 4 s chunks: 64 256 samples, 252
     frames, 257 rows) on a 10 s clip against the float32 model on the CPU;
     StreamingEnhancer at K = 1 and 8 streams, async_depth 0 and 2, fed
     pieces of seeded sizes, bit for bit against overlapped_chunk run with
     as many rows, and each of the 8 rows against its single stream; the
     sub-band mode (SequenceModel(31, 2, 384), 257 rows) and the modes mag,
     scaled_mask, complex_full_band_crm_mask and time_domain around a
     full-band LSTM (H=512), card against CPU; the batched enhance_dir over
     mixed buckets (8 x 10 s, 5 x 7.5 s) against the serial path (and
     where a batch and its first clip part: the full-band towers, while the
     sub-band model's rows stay bit for bit, and, op by op through the three
     TCN towers, the first op whose output for clip 0 depends on the batch),
     and one real halving of a batch of 30 s clips under a lowered memory
     limit; the
     inference CLI in process (JSON config, a .pth, three wavs) on the card
     and on the CPU; each with its exact launches; then the streaming
     readings (the chunk's time on the card, feed-to-finalized latency p50,
     aggregate x realtime) at K = 1, 8 and 16, 4 s and 1 s chunks.
 14. training with validation at FullSubNet+'s full width, bf16 (phase 6's
     seeded weights, the sub-band output layer near the identity mask):
     EnhanceTrainer.train for 2 epochs of one 18 x 3.072 s batch, validating
     4 speech-like (noisy, clean) pairs of 3-10 s each epoch (the 10 s clip
     under a lowered gates limit, so kernel B runs for it) and a probe of 2
     pairs at another SNR at weight 0.5, with exact launches per validation
     and per step; finite STOI, SI_SDR and WB_PESQ on every clip;
     best_score.json (probe weight 0.5) and latest.pt with the same best
     score; report.html with the validation series; the model back in
     training mode, its state equal to the checkpoint saved before the last
     validation and the next step's loss equal to one without it; the
     validation's wall time per clip, its time on the card and the host's
     metric time; the card's bf16 validation means against ModelValidator on
     the float32 model on the CPU.
 15. training from a corpus on disk through the training CLI, FullSubNet+
     at configs/enhance_train.yaml's full width, bf16: a corpus written into
     a temporary directory (36 clean and 6 noise clips of 6 s from
     write_synthetic_corpus, four clean clips also as FLAC in the clean scp,
     8 RIRs from make_rir_bank, scp lists from cli/tools.gen_lst, 4
     validation and 2 probe pairs from TestSampleGenerator); the FLAC clips
     through the native binding, built at first use with soundfile hidden,
     against their WAVs within one int16 step; two loader passes with one
     seed identical at 1 and 24 workers; cli.train.main with a JSON config
     (the DNS scp regime, 3.072 s clips, batch 18, 24 workers, RIRs at 0.75,
     validation every epoch with the probe at weight 0.5) for 2 epochs, then
     -R for one more, with exact launches per step and per validation (the
     6 s clips of V under phase 14's gates limit take kernel B), finite
     losses, the resume at the saved step and best score, best_score.json's
     probe weight; cli.validate.main on the best checkpoint over an
     AudioDataset of the corpus; and the readings: ms per step through the
     loader beside phase 6's, the loader's host time per batch at 1 and 24
     workers, the mixing time per clip, clips per second, a profile of one
     loader-fed step, validation_results.json's means.
 16. the denoising-NPPC line at full width, bf16 (scripts/denoising_nppc_e2e
     .py's configuration: the frozen enhancer FullSubNet+ with one drop_band
     group, the MultiDirection head with 5 directions and 2 groups; random
     weights from a numpy seed in the JAX layout, carried across by
     convert_denoising_nppc): forward_with_pred_crm on a 1 s clip against
     the float32 model on the CPU and the card's directions orthogonal,
     with each offline_laplace_norm call's divisor (the stream's signed mean
     + 1e-5) on both sides; this holds only at seeds where every divisor
     keeps its sign between bf16 and float32, so the head alone
     (MultiDirectionFullSubNetPlus) also runs in bf16 on the card over the
     float32 enhancer's streams against float32 on the CPU at five seeds of
     the weights, 0 and 31 among them, each within PATH_REL, with 2 kernel-A
     launches each and its divisors; five NPPCDenoisingTrainer steps on one 8 x 3.072 s batch with
     configs/denoising_nppc.yaml's lr, lambda and grace, with exact launches
     (2 A for the frozen enhancer, 2 C and 2 D for the head), finite
     objectives, the enhancer bit for bit unchanged and without gradient, a
     finite non-zero gradient per head tensor, ms per step, clips/s, peak
     memory and a profile of one step; a 4 x 1 s objective, reconst_err and
     head gradients in bf16 against the float32 trainer on the CPU;
     DenoisingNPPCValidator on a 6 s speech-like clip with its clean
     reference under phase 14's gates limit (kernel B), its 5 x 6 variation
     wavs against the CPU's float32 model, the PNG's size, the wall time
     per sample; cli.train's nppc_denoising line with the yaml's train:
     block (n_dirs 5) on a corpus in a temporary directory, 2 epochs of 2
     steps and -R for one more, with exact launches per step, the resume
     and metrics_final_*.json.
 17. the inpainting-NPPC line at the full width of configs/inpainting_*.yaml
     (UNets 64 -> 512 over a 128 x 256 log-magnitude spectrogram, batch
     128, 5 directions; random weights from a numpy seed in the JAX layout,
     carried across by convert_inpainting_nppc), float32 with cuDNN's TF32
     convolutions, activations channels-last: the restoration output and
     w_mat on 2 items, card (TF32 and strict float32) against the CPU, the
     directions orthogonal; one restoration loss and gradient at batch 4,
     TF32 against strict float32, every gradient finite and non-zero; five
     RestorationTrainer steps at batch 128 (ms per step, samples/s, peak
     memory, every running statistic moved) and a profile of one; five
     NPPCInpaintingTrainer base steps over the trained UNet (the frozen
     UNet's parameters and buffers bit for bit unchanged) and a profile of
     one; three mc_pca_aligned steps at batch 16 (50 passes, 5 a forward)
     and the passes chunked == unchunked bit for bit; RestorationValidator
     on 4 items and NPPCValidator on one 2.044 s speech-like sample (50 MC
     passes, the 13-alpha grid, 25 wavs with the clean phase, YIN pitch,
     the JSON, 75 PNGs), wall per sample split into card (CUDA events) and
     host; cli.train's restoration line on 24 verbatim FLAC clips in a
     LibriSpeech layout with *.trans.txt (2 epochs of 2 steps at batch 16
     with a validation block, then -R for one more) and the
     nppc_inpainting line over its best/, then -R, with the loader-fed
     step times. No scan kernel is on this path: every launch count stays
     0 through phase 17.
 18. the rest of queue A item 5 at full width, random weights from a numpy
     seed in the JAX layout: FullSubNet+ (bf16) in seven configurations
     that take every norm and every channel attention (TSSE over the
     sub-band fold of 10, SE over the fold of 2 with the cumulative Laplace
     norm, CBAM with the offline Gaussian norm, ECA with the cumulative
     layer norm, TSSE with the forgetting norm, SE with the sub-band
     forgetting norm, CBAM with the hybrid norm): each a 1 s clip against
     the float32 model on the CPU, cRM and wav (for the four norms that
     divide each frame by a running mean, with the clip's magnitude in all
     three streams, and on a 10 s request's own streams each norm in
     float64 and each attention, card against CPU; see _own_streams), 10 s
     requests timed beside the default configuration's with exactly 2
     launches of kernel A each, and for the first two one training step at
     18 x 3.072 s with exactly 2 C and 2 D and a finite non-zero gradient
     per tensor; ComplexSequenceModel with LSTM and GRU towers (2 x 257
     features, H=384, 2 layers), served at [8, 514, 628] with exactly 4
     scans over 16 rows each, against the float32 CPU model, and trained at
     [18, 514, 195] with exactly 4 C and 4 D (LSTM) or 4 + 4 + 4 GRU
     launches, every one of those scan launches held on its recorded
     operands against its plain version under phases 2, 3, 9 and 10's
     limits; the forgetting norms' block products against
     their loops, both timed; MOSNet at its published width on a 10 s and a
     25 s clip, card against CPU, with the wall per window; conv-STFT ->
     conv-iSTFT on 4 mics x 10 s, both directional feature computers, the
     three beamforming ops, a causal and a no-skip TCN stack and both causal
     conv blocks in train and eval, float32, card against CPU within 1e-4 of
     the peak.
 19. the image-NPPC line, float32 with cuDNN's TF32 convolutions, NCHW: at
     the width of configs/image_*.yaml (UNet
     32 -> 128, bottleneck 256; MNIST's 1 x 28 x 28 padded to 32 on
     synthetic digits, batch 64, 5 directions) and with the line's largest
     nets (the res_unet restoration net 64 -> 256 with attention over 3 x
     256 x 256 under inpainting_2's mask; the res_cnn pre-net NPPC under
     super_resolution_1, 64 x 64 in and 256 out), random weights from a
     numpy seed in the JAX layout (convert.random_image_net_params): the
     restored images and the directions, card (TF32 and strict float32)
     against the float32 CPU, the card's directions orthogonal; the loss
     and gradients, TF32 against strict float32 under phase 17's limits,
     every gradient finite and non-zero; ImageRestorationTrainer and
     ImageNPPCTrainer steps (five at batch 64, three at batch 4 for the large
     nets: ms, samples/s, peak memory), a profile of one batch-64 step each,
     the frozen restoration net bit for bit unchanged, the NPPC benchmark;
     the restoration steps in NCHW and channels-last in alternating rounds;
     cli.train's image_restoration and image_nppc lines with the shipped
     configs (as JSON) for 4 steps with a benchmark every 2, the NPPC line
     over the first run's latest, both writing latest.pt, best.pt and
     report.html with its image grids. No scan kernel is on this path:
     every launch count stays 0 through phase 19.
 20. multi-GPU training on the one card, each part through cli.launch
     running this script's --phase20 mode as the ranks: (a) NCCL, a world
     of one: three DDP steps of EnhanceTrainer at EnhanceTrainConfig()'s
     full width (18 x 3.072 s, bf16) bit for bit against three plain
     steps on the same seeded weights and batch, with exact launches and
     the ms of each step beside phase 6's, then cli.train's enhance line
     on phase 15's corpus for 2 steps and -R (latest_step.json 2, then 4);
     (b) gloo, 2 ranks sharing the card, 9 rows each of the global batch
     of 18 (rank 1's first row in drop_band group 1): the step-1 loss and
     the averaged gradient (cosine, norm) against one process on the card,
     exactly 2 C and 2 D a step on each rank; (c) gloo, 2 ranks: the
     restoration line at configs/inpainting_*.yaml's width, batch 128 (64
     a rank), strict float32, two steps: losses and BatchNorm running
     statistics against one process. The ranks' C and D launches add to
     the kernels line's.
 21. the band axis on the one card, through cli.launch running this
     script's --phase21 mode as gloo ranks sharing the card: (a) 2 ranks,
     make_mesh(data=1, band=2): two EnhanceTrainer steps of FullSubNet+
     and then of FullSubNet v1-GRU at full width on phase 20's batch of 18
     (bf16), each rank's sub-band scans over its 1152 of the 2304 sub-band
     rows (the v1 full-band GRU over all 18 rows); (b) 4 ranks,
     make_mesh(data=2, band=2): two FullSubNet+ steps, 9 rows a data group
     and 576 sub-band rows a rank. Against one process on the card: the
     step-1 loss and gradient under phase 20's limits, every rank's
     parameters bit for bit equal, exact launches a step on each rank,
     each rank's step-1 scan launches (kernels C and D; the GRU forward
     and backward) held on their operands against the plain versions; the
     ms of each step and the split's and gather's share of it (CUDA events
     around them). The ranks' launches add to the kernels line's.
 22. the float32 compute mode, the JAX models' default dtype, at full width:
     a float32 model on the card runs its recurrent layers on the mixed
     route (bf16 gates from the fp32-accumulated projection plus the fp32
     bias, rounded once; the scan kernels with float32 output) and the rest
     in strict float32. (a) FullSubNet+: a 10 s request (2 kernel A
     launches, float32 output) and a 30 s request under the lowered gates
     limit (kernel B), against the float32 model on the CPU within
     PATH_REL, every launch held on its operands against its plain version;
     the 10 s request's ms beside the bf16 model's and beside float32 with
     TF32; (b) five EnhanceTrainer steps at compute_dtype "float32", 18 x
     3.072 s, exactly 2 C and 2 D a step, step 1's C and D on their
     operands, step 1's loss and gradient against the bf16 step's, 4 x 1 s
     against the CPU, the ms a step beside phase 6's; (c) a float32 v1-GRU
     step (4 + 4 + 4 GRU launches, each on its operands) and a 10 s v1-GRU
     request whose sub-band GRU takes the carry kernel, against the CPU;
     (d) an NPPCDenoisingTrainer step at its default float32 (2 A, 2 C, 2
     D), C and D on their operands, 4 x 1 s against the CPU; (e)
     __graft_entry__.dryrun_multichip's configuration (a narrow
     FullSubNet+, 8 x 4096 samples) over 2 gloo ranks of make_mesh(1, 2)
     sharing the card, this script's --phase22 mode under cli.launch,
     against one process; (f) the three examples of
     generative_audio_torch/examples as subprocesses on the card, each
     exiting 0 (the streaming demo asserts its bit-identity with
     overlapped_chunk). Its launches, the ranks' included, add to the
     kernels line's.
 23. (run after phase 8's single blocks) the streamed cluster forwards
     (csrc/lstm_scan.cu and csrc/gru_scan.cu, entries ending in `_stream`:
     part of each CTA's W_hh^T slice resident, the rest streamed from L2
     through a ring of bulk copies), the route of kernels A-C where no
     resident cluster holds H (above 512) and of the GRU forward (above
     640): each entry, forward and reverse, bf16 and fp32 out, B and the
     GRU carry from a state, bit for bit against the single block at LSTM
     H=640, 768, 1024 and GRU H=768, 1024, and under
     ops.lstm.streamed_forwards() against the resident cluster at LSTM
     H=384, 512 and GRU H=384, 640; against its plain version and timed at
     H=768 x T=195 x 18 rows and H=768 x T=628 x 2056 rows beside the
     single block (in turns), the bound, the plain version and cuDNN, with
     the plan and its modelled step, failing where the plan takes the
     streamed cluster and it is not the faster; then two model paths,
     FullSubNet+ with a 768-unit sub-band LSTM and v1-GRU with a 1024-unit
     full-band GRU: a 1 s clip against the float32 model on the CPU, and,
     with exact launches, a 10 s request, a 30 s request under a lowered
     gates limit (the carry entries; against the unchunked request) and
     one bf16 EnhanceTrainer step of 4 x 1 s (its loss against the CPU's
     float32 loss; its backwards through phase 24's streamed backwards).
     Their launches are the streamed entries' in the kernels line.
 24. (run after phase 23) the streamed cluster backwards
     (csrc/scan_bwd_stream.cu, lstm_scan_bwd_stream and
     gru_scan_bwd_stream: both W_hh operands streamed from L2 through a
     ring each, the dgates tile whole or each CTA's slice read in place),
     the route of kernel D and the GRU backward scan above H=512 where
     their model beats the single block's: each bit for bit against the
     single block at LSTM H=640, 768, 1024 and GRU H=640, 1024, 1072
     (forward-reversed and not) and against the resident cluster under
     forced streamed plans at H=384 and 512; against its plain version at
     H=1536 and 2304; timed at H=1024 x 18, 768 x 2304 and 2304 x 18 rows
     (T=195) beside the single block where it holds H (in turns), the
     bound, the plain version and cuDNN's backward, failing where the plan
     takes the streamed cluster and it is not the faster; then one bf16
     EnhanceTrainer step of 4 x 1 s of a FullSubNet+ with a 1536-unit
     sub-band LSTM (no single block trains it) with exact launches, its
     loss against the CPU's float32. Their launches, and those of phase
     23's training steps, are the streamed backwards' in the kernels
     line.
 25. (run after phase 24) kernels E and F as streamed clusters
     (csrc/lstm_staged_stream.cu, lstm_scan_fwd_unrolled_stream and
     lstm_layer_fwd_stream), the route of the unrolled forward and of
     lstm_layer_tm above H=512: each bit for bit against its single block
     at H=640, 768, 1024 (E at K=2 and 4, also against
     lstm_scan_fwd_stream; F at F=34 and F=H, forward and reverse, bf16
     and fp32 out) and, under ops.lstm.streamed_forwards(), against the
     cluster at H=384 and 512; against its plain version at H=1536 and
     2304 (E at its largest H, 2048 at K=4), with F's step at F=H there;
     timed at H=768 x 18 rows (E T=192, F T=195) and x 2056 rows x T=628
     (F=34 and 768) beside the single block (in turns), the bound, the
     plain version and cuDNN's nn.LSTM, failing where the plan takes the
     streamed cluster and it is not the faster; then the path, with the
     counts set to 0 around each part: lstm_layer_tm over the sub-band
     stacks of a 768- and a 1536-unit FullSubNet+ (one 8 x 10 s request)
     against the model's hoisted stack, and lstm_unrolled and
     lstm_scan_tm(block_t=K) at H=768, 1536, 2048 and 2304 against kernel
     A's route, with the refusals above E's largest H. The path's launches
     are the two entries' in the kernels line.
 26. (run after phase 25) kernels A and B as wide clusters
     (csrc/lstm_scan_wide.cu, lstm_scan_fwd_wide and
     lstm_scan_fwd_carry_wide: each step's product on warpgroup MMA
     (wgmma), one h buffer a CTA sent by bulk copies, the gates by
     TMA), the route of both where a resident cluster holds H and the wide
     cluster's modelled waves x step are the less (the 8 x 10 s batch):
     whether wgmma's fp32 sums equal mma.sync's bit for bit (the answer
     and the worst difference against the resident cluster, which must be
     WGMMA_EQUALS_MMA_SYNC), every instance's registers without a spill,
     both bit for bit against the resident cluster at 2056, 2047 and 257
     rows x T=628 and H=512 x 18 x 195, forward and reverse, bf16 and fp32
     out, B from a state and in chunks of T_CHUNK against unchunked, two
     runs of one plan against each other, at fp32 out against their plain
     versions; timed at 2056 and
     257 rows beside the resident cluster (in turns), the plain version,
     cuDNN and the bound, with the plan and the route's pick; then the
     path, FullSubNet+ on the route with the counts set to 0 around each
     part: a 10 s request and the batched 8 x 10 s forward (both
     profiled) and that batch under a lowered gates limit (kernel B's
     chunks). The path's launches add to the two entries' in the kernels
     line. Phase 2 holds the resident cluster under
     ops.lstm.resident_forwards(); the serving phases' launch checks name
     kernel A's and B's entries as the route takes them at each call's
     rows (routed).
 27. (run after phase 26) kernel D as a wide cluster
     (csrc/lstm_scan_bwd_wide.cu, lstm_scan_bwd_wide: the dgates exchange
     read back from L2 by TMA in kernel D's k order, both W_hh operands
     streamed, z, dh and dc of up to 2 x 3 m16 tiles x 8-unit groups in a
     warp's registers), the route of kernel D where a resident cluster
     holds H and the wide cluster's modelled waves x step are the less (the
     sub-band training batch): every wide plan of a spread bit for bit
     against the single block at small ragged shapes
     (scripts/perf_bwd_scan.py check_wide); bit for bit against the
     resident cluster and the single block at 2304, 2295 and 1024 rows x
     T=195 and H=512 x 18 x 195, forward and reverse, within the dgates
     limits of its plain version; timed at 2304 rows beside the resident
     cluster (in turns), the plain version, cuDNN's backward and the bound,
     with the plan, the route's pick and the instances' registers; then the
     path, FullSubNet+'s bf16 training step on the route with exact
     launches, its median beside the resident cluster's under
     ops.lstm.resident_backwards() (in turns), its peak memory and a
     profile. Phases 3, 8's full band and 12 hold the resident cluster
     under resident_backwards(); the training phases' launch checks name
     kernel D's entry as the route takes it at each step's sub-band rows
     (routed, routed_step).
 28. (run after phase 10) the GRU training backward (TPU row 7): the scan
     as a wide cluster (csrc/gru_scan_bwd_wide.cu, gru_scan_bwd_wide: both
     products on wgmma with a warpgroup a 64 rows, up to 192 rows a
     cluster of 8, h_prev, the cell's operands and the dgh pieces read
     back from L2 through one TMA ring), the route of the GRU backward
     where its modelled waves x step are the less (v1's sub-band training
     batch, one wave), its instances' registers without a spill, every
     GRU wide plan of a spread and the scan at 2304, 2295, 1152, 1024 rows
     x T=195 and H=512 x 18 x 195 bit for
     bit against the resident cluster and the single block (dgx, dhn,
     every db_hh partial) and within row 7's limits of the plain version;
     timed at 2304 rows beside the resident cluster (in turns), the plain
     version, cuDNN's GRU backward and the bound; the dW_hh contraction's
     second design (one wgmma group in flight, slices by ops.gru.plan_dwhh)
     beside its first (plan_dwhh_first) and one torch.mm in turns at N =
     446 976 and 3492, bit for bit in two runs and within DWHH_ORDER_REL of
     both; then FullSubNet v1-GRU's bf16 training step on the routes with
     exact launches beside resident_backwards() with the first contraction
     (in turns), its peak memory and a profile. Phase 10 holds the GRU's
     resident cluster under resident_backwards(); the v1-GRU launch checks
     name the GRU backward's entry as the route takes it at each scan's
     rows (routed, routed_step).
 29. (run after phase 27) kernel C as a wide cluster
     (csrc/lstm_scan_wide.cu, lstm_scan_fwd_train_wide: kernel A's wide
     cluster, products on wgmma, that also stores the bf16 c sequence from
     the registers that hold c, so its instances and plans are kernel
     A's), the route of kernel C where a resident cluster holds H and the
     wide cluster's modelled waves x step are the less (the sub-band
     training batch): the instances' registers without a spill; h_seq and
     c_seq bit for bit against the resident cluster at 2304, 2295 and 1024
     rows x T=195 and H=512 x 18 x 195, forward and reverse, h against the
     wide kernel A's, two runs of one plan against each other, both within
     phase 3's limits of the plain version; timed at 2304 and 1024 rows
     beside the resident cluster (in turns), the plain version, cuDNN's
     training forward and the bound, with both plans and the route's
     pick; then the path, FullSubNet+'s bf16 training step on the route
     beside ops.lstm.resident_forwards() (in turns) with exact launches,
     medians and a profile of each. The route's launches add to the wide
     entry's in the kernels line, resident_forwards()' to the resident
     entry's (its own path). Phases 3 and 8 hold kernel C's resident
     cluster under resident_forwards(); the training phases' launch checks
     name kernel C's entry as the route takes it at each step's sub-band
     rows (routed, routed_step).
 30. (run after phase 28) the GRU forward and carry (TPU rows 6 and 8) as
     wide clusters (csrc/gru_scan_wide.cu, gru_scan_fwd_wide and
     gru_scan_fwd_carry_wide: kernel A's wide design with the GRU cell,
     each step's product on wgmma with a fourth gate row of zeros a unit,
     W_hh^T streamed from L2 through a ring, one h buffer a CTA sent by
     bulk copies, the gates by TMA), the route of both where a resident
     cluster holds H and the wide cluster's modelled waves x step are the
     less: the instances' registers without a spill; both bit for bit
     against the resident cluster at 2056, 2047 and 257 rows x T=628,
     2304, 2295 and 1024 rows x T=195 and H=512 x 18 x 195 and x 8 x 628,
     forward and reverse, bf16 and fp32 out, the carry from a state and in
     chunks of T_CHUNK against unchunked, two runs against each other,
     within the GRU forward's limits of the plain version; timed at 2056 x
     628 (both entries), 2304 x 195, 257 x 628 and H=512 x 18 x 195 beside
     the resident cluster (in turns), the plain version, cuDNN's nn.GRU
     and the bound, with both plans and the route's pick (failing where
     the route takes the slower design), and the planner's plan at 2304
     rows against the one-wave plan of 160 rows; then the path, FullSubNet
     v1-GRU's batched 8 x 10 s forward (exact launches, profiled on the
     route and under resident_forwards()) and its bf16 training step on
     the route beside resident_forwards() in turns, with exact launches,
     medians and profiles. Phases 9 and 10 hold the GRU's resident cluster
     under resident_forwards(); the v1-GRU launch checks name the GRU
     forward's and carry's entries as the route takes them at each call's
     rows, sub-band and full band (routed, routed_counts, routed_step,
     forward_counts).
The launch counts are set to 0 just before each model's serving phases and
read just after, again around each model's five training steps, around
each variant's own path in phase 12 and around phases 13, 14 and 15, each
path of phase 16 and phase 18's model paths (whose launches add to kernel
A's, in phases 14-16 to kernel B's too, in phases 15-16 and 18 to kernels
C's and D's, and in phase 18 to the GRU kernels'), and in each rank of
phase 20 around each DDP step and each cli.train run (whose launches add to
kernels C's and D's) and of phase 21 around each step (C's and D's, and the
GRU kernels'), and around each part of phase 22 and in its ranks (A's, B's,
C's, D's and the GRU kernels'), and around each request and step of
phase 23's model paths (the streamed entries') and phase 24's training
step (the streamed backwards'), and around each part of phase 25's path
(kernels E's and F's streamed clusters') and of phase 26's (the wide
clusters') and around each training step of phases 27, 28 and 29 (the
wide backwards' and kernel C's two designs') and around phase 30's
forward and each of its training steps (the GRU forward's two designs').
The second-to-last line of
stdout is the `kernels` JSON, the last line the device JSON. Exits
non-zero without a CUDA device. `python3 chip_smoke.py --phase20 PART
OUT` is a rank of phase 20, `--phase21 PART OUT` one of phase 21,
`--phase22 graft OUT` one of phase 22, run by cli.launch.
"""
import contextlib
import dataclasses
import inspect
import json
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from generative_audio_torch.utils.device import cuda_ms  # noqa: E402

T_FRAMES, HIDDEN, ROWS, RAGGED_ROWS = 628, 384, 8 * 257, 2047
T_CHUNK = 64
# The training shape: 3.072 s clips give 193 frames + 2 look-ahead; batch 18
# x 257 bins, drop_band keeps 128 of them per clip.
TRAIN_T, TRAIN_ROWS, TRAIN_RAGGED_ROWS = 195, 18 * 128, 18 * 128 - 9
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_STEPS = 18, 49152, 5
# FullSubNet v1's full-band model: H=512 over as many rows as clips.
FB_HIDDEN, FB_SERVE_ROWS = 512, 8
SEED = 0
# The median ms of phase 6's training steps 2-5 by model (and of phase 16's
# NPPC steps under "nppc"), for phases 15 and 22.
STEP_MS = {}
# Lowered gates limit of phase 4: a 30 s clip's gates (1.48 GB) exceed it.
LONG_CLIP_GATES_LIMIT = 256 << 20
# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Tolerances. Kernel vs plain version: both accumulate in fp32 over bf16
# operands in another order, and a float32 difference that moves h across a
# bf16 rounding step changes the next product by up to one bf16 step. On an
# H100 the largest difference over the 8e8 outputs of a T=628, 2056-row
# scan measured 3.4e-4 and the mean 2.2e-6 (h lies in (-1, 1)); the limits
# keep a margin of about 15x over those.
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 5e-3, 3e-5
# The largest |c| of phase 6's random gates (measured 2.47-2.55 on an H100),
# where kernel C's c limits (8x those of h) were set.
C_PEAK = 2.5
# Backward scan vs its plain version, as a share of the largest |dgates|:
# the same one-bf16-step differences (2^-8 of a value), which dh carries on
# to earlier steps. On an H100 at T=195, 2304 rows the largest measured
# 3.8e-3 of the peak (one bf16 step of a value above 2) and the mean 7.5e-7.
# The whole LSTMScan gradient vs autograd through the float32 recurrence
# measures what the bf16 streams cost: its limits are shares of the exact
# gradient's peak (dgates; measured 2.9e-3 max, 3.0e-5 mean) and of its
# Frobenius norm (dW_hh; measured 2.3e-3). Margins of about 15x.
# LSTMLayerScan's dW_ih, dW_hh and db measured 2.5e-3, 3.1e-3 and 1.2e-3 of
# their norms and its dx 2.5e-3 max of its peak, under the same limits.
BWD_MAX_REL, BWD_MEAN_REL = 5e-2, 2e-5
GRAD_MAX_REL, GRAD_MEAN_REL, GRAD_DW_REL = 5e-2, 5e-4, 3e-2
# LSTMLayerScan's dx is a contraction over 4H of the bf16 dgates, so each
# rounding adds up: at T=195, 2304 rows, F=34 its mean error measured 3.4e-4
# of its peak on an H100, too close to GRAD_MEAN_REL, so dx has its own mean
# limit, 2.9x over that reading. The run also reads two faulty dx, and fails
# unless the limits reject them: dgates without the forget gate's derivative
# measured a mean of 7.4e-3 (7.4x over the limit); one of the 195 steps lost
# a max of 0.79 (16x over GRAD_MAX_REL) and a mean of 1.04e-3.
DX_MEAN_REL = 1e-3
# The GRU forward vs its plain version: the same one-bf16-step differences,
# but the update h = (1 - z) n + z h_prev hands a moved h on to later steps
# where the LSTM's output gate damps it, so the mean is higher: on an H100 at
# T=628 the largest difference measured 8.9e-4 and the mean 2.1e-5 (2.5e-5 at
# H=512). The maximum keeps the LSTM's limit, the mean gets its own, 8x over.
GRU_FWD_MEAN_ABS = 2e-4
# The GRU backward's dW_hh and db_hh against the plain version, as a share
# of the plain result's Frobenius norm: both contract the same bf16 streams
# up to the one-bf16-step differences above, in another order (measured
# 5.4e-4 and 1.1e-4). The dW_hh contraction alone, on the very same bf16
# inputs, against a float32 matmul differs only by the order of its fp32
# sums, which grows with the rows summed: measured 3.2e-5 at N = 446 976 rows
# and 3.7e-7 at N = 3492; a wrong fragment layout would give O(1).
BWD_DW_REL, DWHH_ALONE_REL = 1e-2, 1e-3
# Training on the card in bf16 vs the float32 model on the CPU, 4 x 1 s:
# relative loss error (measured 2.0e-4), and per parameter tensor (those
# whose gradient norm is above 1e-3 of the largest) the cosine (measured
# 0.9972 at the lowest) and the ratio of the norms (measured 0.985-1.028).
TRAIN_LOSS_REL, TRAIN_GRAD_COS, TRAIN_GRAD_RATIO = 5e-3, 0.95, 0.15
# The denoising-NPPC step (phase 16), bf16 on the card vs the float32
# trainer on the CPU, 4 x 1 s at the step where lambda reaches its scale:
# the objective and reconst_err (relative; measured 8.3e-5 and 8.9e-5 on an
# H100), and per head tensor that carries the gradient the cosine (lowest
# measured 0.99844) and the ratio of the norms (0.9967-1.0499). The limits
# keep margins of about 20x, 13x on 1 - cosine and 3x on the norms.
NPPC_OBJ_REL, NPPC_GRAD_COS, NPPC_GRAD_RATIO = 2e-3, 0.98, 0.15
# Whole path: bf16 on the card against float32 on the CPU, and chunked
# against unchunked projections (cuBLAS may round a chunk's bf16 gates
# differently), both as a share of the output's peak.
PATH_REL = 5e-2
# The two sub-band layers through lstm_layer_tm against the model's own
# hoisted stack, bf16 h: the hoisted path rounds every gate to bf16, the
# projection inside the scan keeps it in fp32, and layer 2 sees layer 1's
# differences. On an H100 the largest difference measured 1.95e-3 (one bf16
# step of an h in [0.25, 0.5)) and the mean 7.9e-5; margins of 5x and 6x.
LAYER_PATH_MAX_ABS, LAYER_PATH_MEAN_ABS = 1e-2, 5e-4
# The sub-band model's input width: 31 neighbour bins + 3 full-band outputs.
SB_FEATURES = 34
# Hidden sizes the kernels do not take as they are: the wrappers pad them.
PADDED_HIDDEN = (100, 200)
# Hidden sizes no resident cluster holds (LSTM above 512, GRU above 640):
# the forwards take the streamed cluster, and the single block under
# ops.lstm.single_block_forwards(). The GRU runs at the last.
BLOCK_HIDDEN = (640, 768)
ROUTE_NAMES = {"": "clusters", "_stream": "streamed clusters",
               "_block": "single blocks"}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def bound(t, rows, h, extra_bytes=0, streams=5, products=1, gates=4):
    """Least time (ms) for one scan with `gates` gates (4: LSTM, 3: GRU), as
    a function of its inputs and outputs, whatever scratch a kernel adds.
    Bytes: `streams` bf16 [T, rows, H] arrays each read or written once (the
    LSTM forward: 4 of gates in, 1 of h out) and W_hh in bf16 once.
    Operations: `products` [rows, H] x [H, gates*H] products per step on the
    bf16 tensor cores."""
    bytes_ = t * rows * streams * h * 2 + gates * h * h * 2 + extra_bytes
    flops = products * 2 * t * rows * h * gates * h
    return _larger(bytes_, flops)


def _larger(bytes_, flops):
    by_bytes, by_ops = bytes_ / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_build():
    """Builds every source and prints ptxas's report of each instance.
    Returns the registers of the instances of kernels A-C by name (kernel
    and output type), empty for a library that was built before."""
    from generative_audio_torch.ops import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build(list(_cuda.SOURCES))
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_cuda.NVCC_FLAGS)})")
    for name, report in reports.items():
        for line in report.splitlines():
            if "entry function" in line or "registers" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in _cuda.SOURCES:
        _cuda.load(name)
    return {**_cluster_registers(reports.get("lstm_scan", "")),
            **_bwd_registers(reports), **_staged_registers(reports),
            **_chains_registers(reports.get("lstm_scan_bwd_chains", "")),
            **_stream_registers(reports), **_bwd_stream_registers(reports),
            **_staged_stream_registers(reports), **_wide_registers(reports),
            **_wide_bwd_registers(reports), **_gru_wide_registers(reports)}


def _cluster_registers(report):
    """{"A bf16": registers, ...} from ptxas's report of lstm_scan.cu: the
    instance lstm_cluster_kernel<OutT, CARRY, STREAM_C> is kernel A
    (neither flag), B (CARRY) or C (STREAM_C)."""
    found, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"lstm_cluster_kernelI(13__nv_bfloat16|f)"
                          r"Lb([01])ELb([01])E", line)
        if entry:
            out, carry, train = entry.groups()
            kernel = "C" if train == "1" else "B" if carry == "1" else "A"
            name = f"{kernel} {'fp32' if out == 'f' else 'bf16'}"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = int(used.group(1)), None
    return found


def _bwd_registers(reports):
    """{"D cluster, slice resident": "... registers, ... spilled", ...} for
    the cluster instances of the two backward scans (lstm_bwd_cluster_kernel
    and gru_bwd_cluster_kernel <RESIDENT>), from ptxas's reports."""
    found, name, spill = {}, None, ""
    for line in "\n".join(reports.get(s, "") for s in (
            "lstm_scan_bwd", "gru_scan_bwd")).splitlines():
        entry = re.search(r"(lstm|gru)_bwd_cluster_kernelILb([01])E", line)
        if "Compiling entry function" in line:
            name = None
            if entry:
                kind = "D" if entry.group(1) == "lstm" else "GRU backward"
                name = (f"{kind} cluster, slice "
                        f"{'resident' if entry.group(2) == '1' else 'streamed'}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _staged_registers(reports):
    """{"E K=2": "... registers, ... spilled", "F bf16": ...,
    "F block fp32": ..., "E block K=4": ...} for the instances of kernels E
    and F (lstm_scan_staged.cu) and of their single blocks
    (lstm_layer_block.cu, lstm_scan_unrolled_block.cu), from ptxas's
    reports."""
    found, name, spill = {}, None, ""
    out_type = {"13__nv_bfloat16": "bf16", "f": "fp32"}
    for line in "\n".join(reports.get(s, "") for s in (
            "lstm_scan_staged", "lstm_layer_block",
            "lstm_scan_unrolled_block")).splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            e = re.search(r"lstm_unrolled_kernelILi(\d)E", line)
            eb = re.search(r"lstm_unrolled_block_kernelILi(\d)E", line)
            f = re.search(r"lstm_layer_cluster_kernelI(13__nv_bfloat16|f)E",
                          line)
            b = re.search(r"lstm_layer_block_kernelI(13__nv_bfloat16|f)E",
                          line)
            if e:
                name = f"E K={e.group(1)}"
            elif eb:
                name = f"E block K={eb.group(1)}"
            elif f:
                name = f"F {out_type[f.group(1)]}"
            elif b:
                name = f"F block {out_type[b.group(1)]}"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _chains_registers(report):
    """{"G N=2 units streamed": "... registers, ... spilled", ...} for the
    instances lstm_chains_cluster_kernel<N, ARRANGE, RESIDENT> of kernel G
    (lstm_scan_bwd_chains.cu), from ptxas's report."""
    found, name, spill = {}, None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            g = re.search(r"lstm_chains_cluster_kernelILi(\d)ELi(\d)ELb([01])E",
                          line)
            if g:
                name = (f"G N={g.group(1)} "
                        f"{'rows' if g.group(2) == '0' else 'units'} "
                        f"{'resident' if g.group(3) == '1' else 'streamed'}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _registers_line(registers, kernels):
    """The registers of the named kernels' instances, for a phase's log."""
    return ", ".join(f"{k} {n}" for k, n in sorted(registers.items())
                     if k[0] in kernels) or "not rebuilt in this run"


def phase_kernels(dev, registers):
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = HIDDEN
    bound_w = h ** -0.5
    w_hh = (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) * bound_w
    results = {}
    max_a = max_b = 0.0
    for rows in (ROWS, RAGGED_ROWS):
        gates = torch.randn(T_FRAMES, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        log(f"kernel A plan at rows={rows}: "
            f"{_plan_line(L, dev, h, rows, out_dtype=torch.float32)}")
        log(f"kernel B plan at rows={rows}: "
            f"{_plan_line(L, dev, h, rows, carry=True)}")
        for reverse in (False, True):
            got = L.lstm_scan_tm(gates, w_hh, reverse, torch.float32)
            want = L.lstm_scan_reference_tm(gates, w_hh, reverse)
            torch.cuda.synchronize()
            err = (got - want).abs()
            log(f"kernel A rows={rows} reverse={reverse}: max|err| "
                f"{err.max().item():.3e} mean {err.mean().item():.3e}")
            check(torch.isfinite(got).all().item(), "kernel A output finite")
            check(err.max().item() < KERNEL_MAX_ABS
                  and err.mean().item() < KERNEL_MEAN_ABS,
                  f"kernel A vs plain within {KERNEL_MAX_ABS}/{KERNEL_MEAN_ABS}")
            max_a = max(max_a, err.max().item())

            # kernel B over 64-frame chunks (the last one ragged) == kernel A
            for out_dtype in (torch.bfloat16, torch.float32):
                whole = L.lstm_scan_tm(gates, w_hh, reverse, out_dtype)
                hs = torch.zeros(rows, h, device=dev)
                cs = torch.zeros_like(hs)
                chunked = torch.empty_like(whole)
                starts = list(range(0, T_FRAMES, T_CHUNK))
                for s in (starts[::-1] if reverse else starts):
                    e = min(s + T_CHUNK, T_FRAMES)
                    chunked[s:e], hs, cs = L.lstm_scan_carry_tm(
                        gates[s:e], w_hh, hs, cs, reverse, out_dtype)
                check(torch.equal(chunked, whole),
                      f"kernel B in chunks == kernel A bitwise "
                      f"(rows={rows} reverse={reverse} {out_dtype})")
            log(f"kernel B chunks of {T_CHUNK} == kernel A bitwise "
                f"(rows={rows} reverse={reverse}, bf16 and fp32 out)")

            # kernel B against its plain version from a non-zero state
            h0 = torch.rand(rows, h, generator=gen, device=dev) * 2 - 1
            c0 = torch.randn(rows, h, generator=gen, device=dev)
            seq, h_t, c_t = L.lstm_scan_carry_tm(gates[:T_CHUNK], w_hh, h0, c0,
                                                 reverse, torch.float32)
            p_seq, p_h, p_c = L.lstm_scan_carry_reference_tm(
                gates[:T_CHUNK], w_hh, h0, c0, reverse)
            err_b = max((seq - p_seq).abs().max().item(),
                        (h_t - p_h).abs().max().item(),
                        (c_t - p_c).abs().max().item())
            log(f"kernel B rows={rows} reverse={reverse} from (h0, c0): "
                f"max|err| {err_b:.3e}")
            check(err_b < KERNEL_MAX_ABS, "kernel B vs plain")
            max_b = max(max_b, err_b)
        del gates

    # times at the serving shape, bf16 out as the path runs them
    gates = torch.randn(T_FRAMES, ROWS, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=5)
    zeros = torch.zeros(ROWS, h, device=dev)

    def chunked_run():
        hs, cs = zeros, zeros
        for s in range(0, T_FRAMES, T_CHUNK):
            _, hs, cs = L.lstm_scan_carry_tm(gates[s:s + T_CHUNK], w_hh, hs,
                                             cs)

    ms_b = cuda_ms(chunked_run, iters=5)
    # the same work in one chunk, and kernel A at one 10 s clip's 257 rows:
    # separates the cost of chunking from that of the kernel, and of the
    # serial time loop from that of the rows
    ms_b_one = cuda_ms(lambda: L.lstm_scan_carry_tm(gates, w_hh, zeros, zeros),
                       iters=5)
    one_clip = gates[:, :257].contiguous()
    ms_a_257 = cuda_ms(lambda: L.lstm_scan_tm(one_clip, w_hh), iters=5)
    library_257 = library_lstm_ms(one_clip, w_hh)
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    plain_b = cuda_ms(lambda: [L.lstm_scan_carry_reference_tm(
        gates[s:s + T_CHUNK], w_hh, zeros, zeros)
        for s in range(0, T_FRAMES, T_CHUNK)], iters=2)
    library = library_lstm_ms(gates, w_hh)
    n_chunks = -(-T_FRAMES // T_CHUNK)
    b_a, by_a = bound(T_FRAMES, ROWS, h)
    b_b, by_b = bound(T_FRAMES, ROWS, h, extra_bytes=n_chunks * 4 * ROWS * h * 4)
    card = card_line()
    log(f"kernel A at T={T_FRAMES} rows={ROWS} H={h}: {ms_a:.3f} ms, "
        f"{1e3 * ms_a / T_FRAMES:.2f} us a step (bound {b_a:.3f} ms by {by_a}; "
        f"plain {plain_a:.3f} ms; cuDNN LSTM {library:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(L, dev, h, ROWS)}")
    log(f"kernel B, {n_chunks} chunks of {T_CHUNK}: {ms_b:.3f} ms, "
        f"{1e3 * ms_b / T_FRAMES:.2f} us a step (bound {b_b:.3f} ms by {by_b}; "
        f"plain {plain_b:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(L, dev, h, ROWS, carry=True)}")
    log(f"kernel B in one chunk of {T_FRAMES}: {ms_b_one:.3f} ms; kernel A at "
        f"257 rows (one 10 s clip): {ms_a_257:.3f} ms, "
        f"{1e3 * ms_a_257 / T_FRAMES:.2f} us a step (bound "
        f"{bound(T_FRAMES, 257, h)[0]:.3f} ms; cuDNN LSTM {library_257:.3f} "
        f"ms) on {card}")
    log(f"  plan at 257 rows: {_plan_line(L, dev, h, 257)}")
    log(f"  registers of kernels A and B: {_registers_line(registers, 'AB')}")
    log("  (the cuDNN LSTM is nn.LSTM(4H, H) with W_ih = I and zero bias: the "
        "same recurrence plus one extra [T*rows, 4H] x [4H, 4H] projection)")
    results["lstm_scan_fwd"] = dict(
        max_abs_err=max_a, ms=ms_a, plain_ms=plain_a, bound_ms=b_a,
        bound_by=by_a, library_ms=library, plan=_plan_json(L, dev, h, ROWS))
    results["lstm_scan_fwd_carry"] = dict(
        max_abs_err=max_b, ms=ms_b, plain_ms=plain_b, bound_ms=b_b,
        bound_by=by_b, library_ms=library,
        plan=_plan_json(L, dev, h, ROWS, carry=True))
    return results


def library_lstm_ms(gates, w_hh):
    """cuDNN's LSTM on the same gates: W_ih = I, zero biases, so each step
    computes gates_t + h_{t-1} W_hh^T as the kernels do. Timed only."""
    h = w_hh.shape[0]
    lstm = torch.nn.LSTM(4 * h, h, device=gates.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * h))
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        return cuda_ms(lambda: lstm(gates), iters=5)


def library_lstm_train_ms(gates, w_hh, gout=None):
    """cuDNN's LSTM as in library_lstm_ms, in training mode: the forward
    alone (it keeps its reserve space for a backward), and the forward plus
    the backward to the gates and the weights (None without gout). Timed
    only."""
    h = w_hh.shape[0]
    lstm = torch.nn.LSTM(4 * h, h, device=gates.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * h))
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    x = gates.detach().requires_grad_()

    def both():
        lstm(x)[0].backward(gout)
        x.grad = None
        lstm.zero_grad(set_to_none=True)

    return (cuda_ms(lambda: lstm(x), iters=5),
            None if gout is None else cuda_ms(both, iters=5))


def phase_train_kernels(dev, registers):
    """Kernels C (training forward) and D (backward scan) at the training
    shape, and the LSTMScan gradient as a whole."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    # every plan of both backward scans (cluster sizes, rows, the
    # recompute's slice resident or streamed) == the single block, bit for
    # bit, at small ragged shapes, forward and reverse
    check(PB.check(dev) == 0, "every backward plan == the single block "
          "bitwise (scripts/perf_bwd_scan.py check)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, t_len = HIDDEN, TRAIN_T
    w_hh = (torch.rand(h, 4 * h, generator=gen, device=dev) * 2 - 1) * h ** -0.5
    max_c = max_d = 0.0
    for rows, reverse in ((TRAIN_ROWS, False), (TRAIN_ROWS, True),
                          (TRAIN_RAGGED_ROWS, False), (TRAIN_RAGGED_ROWS, True)):
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        gout = torch.randn(t_len, rows, h, generator=gen,
                           device=dev).to(torch.bfloat16)
        tag = f"rows={rows} reverse={reverse}"
        if not reverse:
            log(f"kernel C plan at rows={rows}: "
                f"{_plan_line(L, dev, h, rows, train=True)}")
        with torch.no_grad():
            h_a = L.lstm_scan_tm(gates, w_hh, reverse)
        h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh, reverse)
        p_h, p_c = L.lstm_scan_train_reference_tm(gates, w_hh, reverse)
        torch.cuda.synchronize()
        check(torch.equal(h_seq, h_a), f"kernel C h == kernel A h bitwise ({tag})")
        err_c = (c_seq.float() - p_c.float()).abs()
        err_h = (h_seq.float() - p_h.float()).abs()
        log(f"kernel C {tag}: h == kernel A bitwise; c_seq max|err| "
            f"{err_c.max().item():.3e} mean {err_c.mean().item():.3e} (peak |c| "
            f"{p_c.float().abs().max().item():.2f}); h_seq max|err| "
            f"{err_h.max().item():.3e}")
        check(torch.isfinite(c_seq.float()).all().item(), "kernel C c finite")
        # c is O(1) where h is below 1, and it is rounded to bf16 (2^-8 of
        # its value) on both sides, so its limits are those of h times 8
        check(err_c.max().item() < 8 * KERNEL_MAX_ABS
              and err_c.mean().item() < 8 * KERNEL_MEAN_ABS
              and err_h.max().item() < 8 * KERNEL_MAX_ABS,
              f"kernel C vs plain within {8 * KERNEL_MAX_ABS}/"
              f"{8 * KERNEL_MEAN_ABS} ({tag})")
        max_c = max(max_c, err_c.max().item())

        dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh, reverse)
        p_dg = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh,
                                            reverse)
        torch.cuda.synchronize()
        err_d = (dg.float() - p_dg.float()).abs()
        peak = p_dg.float().abs().max().item()
        log(f"kernel D {tag}: dgates max|err| {err_d.max().item():.3e} mean "
            f"{err_d.mean().item():.3e} (peak |dgates| {peak:.3f})")
        check(torch.isfinite(dg.float()).all().item(), "kernel D output finite")
        check(err_d.max().item() < BWD_MAX_REL * peak
              and err_d.mean().item() < BWD_MEAN_REL * peak,
              f"kernel D vs plain within {BWD_MAX_REL}/{BWD_MEAN_REL} of the "
              f"peak ({tag})")
        max_d = max(max_d, err_d.max().item())
        # the card's plan (a cluster) against the single-block design
        dg_block = L.lstm_scan_bwd_planned_tm(gates, h_seq, c_seq, gout, w_hh,
                                              _block_bwd_plan(L, dev, h, rows),
                                              reverse)
        torch.cuda.synchronize()
        check(torch.equal(dg, dg_block),
              f"kernel D's plan == the single block bitwise ({tag})")
        log(f"kernel D {tag}: plan {_bwd_plan_line(L, dev, h, rows)}; == the "
            f"single block bitwise over {dg.numel()} outputs")
        del dg_block

        # LSTMScan as a whole against autograd through the fp32 recurrence
        _lstm_scan_grads_vs_float32(L, gates, w_hh, gout, reverse, tag)
        del gates, gout

    # times at the training shape
    rows = TRAIN_ROWS
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    with torch.no_grad():
        ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=5)
    ms_c = cuda_ms(lambda: L.lstm_scan_train_tm(gates, w_hh), iters=5)
    # one 16-row block per SM: what the 144 blocks' second wave costs
    one_wave = 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    part = gates[:, :one_wave].contiguous()
    ms_c_wave = cuda_ms(lambda: L.lstm_scan_train_tm(part, w_hh), iters=5)
    ms_d = cuda_ms(lambda: L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh),
                   iters=5)
    block = _block_bwd_plan(L, dev, h, rows)
    ms_d_block = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(
        gates, h_seq, c_seq, gout, w_hh, block), iters=3)
    plain_c = cuda_ms(lambda: L.lstm_scan_train_reference_tm(gates, w_hh),
                      iters=2)
    plain_d = cuda_ms(lambda: L.lstm_scan_bwd_reference_tm(
        gates, h_seq, c_seq, gout, w_hh), iters=2)
    lib_fwd, lib_both = library_lstm_train_ms(gates, w_hh, gout)
    # C: gates in, h and c out. D: gates, h, c, gout in, dgates out, two
    # products per step (its second layout of W_hh is the wrapper's copy).
    b_c, by_c = bound(t_len, rows, h, streams=6)
    b_d, by_d = bound(t_len, rows, h, streams=11, products=2)
    card = card_line()
    log(f"kernel C at T={t_len} rows={rows} H={h}: {ms_c:.3f} ms, "
        f"{1e3 * ms_c / t_len:.2f} us a step (kernel A on the same gates "
        f"{ms_a:.3f} ms; bound {b_c:.3f} ms by {by_c}; plain {plain_c:.3f} ms; "
        f"cuDNN LSTM forward, training mode, {lib_fwd:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(L, dev, h, rows, train=True)}; registers "
        f"{_registers_line(registers, 'C')}")
    log(f"kernel C at {one_wave} rows (16 a SM): {ms_c_wave:.3f} ms on {card}")
    log(f"  plan: {_plan_line(L, dev, h, one_wave, train=True)}")
    log(f"kernel D at T={t_len} rows={rows} H={h}: {ms_d:.3f} ms, "
        f"{1e3 * ms_d / t_len:.2f} us a step (the single-block design "
        f"{ms_d_block:.3f} ms; bound {b_d:.3f} ms by {by_d}; plain "
        f"{plain_d:.3f} ms; cuDNN LSTM backward {lib_both - lib_fwd:.3f} ms = "
        f"forward + backward {lib_both:.3f} ms less the forward) on {card}")
    log(f"  plan: {_bwd_plan_line(L, dev, h, rows)}; registers "
        f"{_registers_line(registers, 'D')}")
    return {
        "lstm_scan_fwd_train": dict(
            max_abs_err=max_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
            bound_by=by_c, library_ms=lib_fwd,
            plan=_plan_json(L, dev, h, rows, train=True)),
        "lstm_scan_bwd": dict(
            max_abs_err=max_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
            bound_by=by_d, library_ms=lib_both - lib_fwd,
            single_block_ms=ms_d_block,
            plan=dataclasses.asdict(L.card_bwd_scan_plan(dev, h, rows)))}


def _uniform(gen, dev, shape, bound):
    return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * bound


def _lstm_scan_grads_vs_float32(L, gates, w_hh, gout, reverse, tag):
    """LSTMScan's two gradients (bf16 gates on the card, through kernels C
    and D) for the cotangent gout against autograd through the float32
    recurrence, within GRAD_MAX_REL / GRAD_MEAN_REL of the peak (dgates)
    and GRAD_DW_REL of the norm (dW_hh)."""
    g_k = gates.clone().requires_grad_()
    w_k = w_hh.clone().requires_grad_()
    (L.lstm_scan_tm(g_k, w_k, reverse, torch.float32)
     * gout.float()).sum().backward()
    g_x = gates.float().requires_grad_()
    w_x = w_hh.clone().requires_grad_()
    (L.lstm_scan_reference_tm(g_x, w_x, reverse,
                              compute_dtype=torch.float32)
     * gout.float()).sum().backward()
    torch.cuda.synchronize()
    check(g_k.grad.dtype == torch.bfloat16
          and w_k.grad.dtype == torch.float32, "LSTMScan gradient dtypes")
    err_g = (g_k.grad.float() - g_x.grad).abs()
    peak_g = g_x.grad.abs().max().item()
    rel_w = ((w_k.grad - w_x.grad).norm() / w_x.grad.norm()).item()
    log(f"LSTMScan {tag} vs float32 autograd: d gates max|err|/peak "
        f"{err_g.max().item() / peak_g:.3e} mean/peak "
        f"{err_g.mean().item() / peak_g:.3e}; dW_hh |err|/|dW_hh| "
        f"{rel_w:.3e}")
    check(err_g.max().item() < GRAD_MAX_REL * peak_g
          and err_g.mean().item() < GRAD_MEAN_REL * peak_g
          and rel_w < GRAD_DW_REL,
          f"LSTMScan gradient vs float32 within {GRAD_MAX_REL}/"
          f"{GRAD_MEAN_REL}/{GRAD_DW_REL} ({tag})")


def phase_lstm_train_large(dev):
    """LSTMScan (kernel C's and kernel D's streamed clusters) at H=768 and
    1024, which no resident cluster holds: both gradients against autograd
    through the float32 recurrence, forward and reverse, with the launches
    counted around it. (Kernel D's single block at H=1024 is timed beside
    the streamed cluster in phase 24.)"""
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    t_len, rows = T_CHUNK, 40
    L.reset_launch_counts()
    for h in (BLOCK_HIDDEN[-1], 1024):
        check(L.card_bwd_scan_plan(dev, h, rows).design == "stream",
              f"kernel D at H={h} takes its streamed cluster")
        w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        for reverse in (False, True):
            gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            gout = torch.randn(t_len, rows, h, generator=gen,
                               device=dev).to(torch.bfloat16)
            _lstm_scan_grads_vs_float32(
                L, gates, w_hh, gout, reverse,
                f"H={h} T={t_len} rows={rows} reverse={reverse}")
    launches = {k: n for k, n in L.launch_counts.items() if n}
    log(f"launches of LSTMScan at H=768 and 1024: {launches}")
    check(launches == {"lstm_scan_fwd_train_stream": 4,
                       "lstm_scan_bwd_stream": 4},
          "LSTMScan at H=768 and 1024 runs kernel C's and kernel D's "
          "streamed clusters once a gradient")


def phase_lstm_h512(dev, registers):
    """The three LSTM scan kernels at FullSubNet v1's full-band shape, where
    the v1-LSTM model runs them: H=512, very few rows; kernel D's plan (a
    cluster of 16) against the single block bit for bit, and both designs'
    times at 18 rows. Returns kernel D's numbers there."""
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    h, t_len = FB_HIDDEN, TRAIN_T
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    for rows in (TRAIN_BATCH, 1):
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        gout = torch.randn(t_len, rows, h, generator=gen,
                           device=dev).to(torch.bfloat16)
        log(f"LSTM H={h} rows={rows}: kernel A plan {_plan_line(L, dev, h, rows)}"
            f"; kernel C plan {_plan_line(L, dev, h, rows, train=True)}")
        for reverse in (False, True):
            tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
            with torch.no_grad():
                h_a = L.lstm_scan_tm(gates, w_hh, reverse, torch.float32)
            want = L.lstm_scan_reference_tm(gates, w_hh, reverse)
            h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh, reverse)
            p_h, p_c = L.lstm_scan_train_reference_tm(gates, w_hh, reverse)
            dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh, reverse)
            p_dg = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout,
                                                w_hh, reverse)
            torch.cuda.synchronize()
            err_a = (h_a - want).abs()
            err_c = (c_seq.float() - p_c.float()).abs()
            err_d = (dg.float() - p_dg.float()).abs()
            peak = p_dg.float().abs().max().item()
            log(f"LSTM kernels {tag}: A max|err| {err_a.max().item():.3e} mean "
                f"{err_a.mean().item():.3e}; C h == A bitwise "
                f"{torch.equal(h_seq, h_a.to(torch.bfloat16))}, c_seq max|err| "
                f"{err_c.max().item():.3e}; D max|err| {err_d.max().item():.3e} "
                f"mean {err_d.mean().item():.3e} (peak |dgates| {peak:.3f})")
            check(all(torch.isfinite(x.float()).all().item()
                      for x in (h_a, c_seq, dg)), f"LSTM kernels finite ({tag})")
            check(err_a.max().item() < KERNEL_MAX_ABS
                  and err_a.mean().item() < KERNEL_MEAN_ABS,
                  f"kernel A vs plain ({tag})")
            check(torch.equal(h_seq, h_a.to(torch.bfloat16)),
                  f"kernel C h == kernel A h bitwise ({tag})")
            check(err_c.max().item() < 8 * KERNEL_MAX_ABS
                  and err_c.mean().item() < 8 * KERNEL_MEAN_ABS,
                  f"kernel C vs plain ({tag})")
            check(err_d.max().item() < BWD_MAX_REL * peak
                  and err_d.mean().item() < BWD_MEAN_REL * peak,
                  f"kernel D vs plain ({tag})")
            dg_block = L.lstm_scan_bwd_planned_tm(
                gates, h_seq, c_seq, gout, w_hh,
                _block_bwd_plan(L, dev, h, rows), reverse)
            torch.cuda.synchronize()
            check(torch.equal(dg, dg_block),
                  f"kernel D's plan == the single block bitwise ({tag})")
            log(f"kernel D {tag}: plan {_bwd_plan_line(L, dev, h, rows)}; == "
                f"the single block bitwise")
        del gates, gout

    # times at the full-band training shape (18 rows, one cluster)
    rows = TRAIN_BATCH
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=10)
    ms_c = cuda_ms(lambda: L.lstm_scan_train_tm(gates, w_hh), iters=10)
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    lib = library_lstm_ms(gates, w_hh)
    b_a, by_a = bound(t_len, rows, h)
    log(f"kernel A at T={t_len} rows={rows} H={h} (full band, training "
        f"batch): {ms_a:.3f} ms, {1e3 * ms_a / t_len:.2f} us a step (bound "
        f"{b_a:.4f} ms by {by_a}; plain {plain_a:.3f} ms; cuDNN LSTM "
        f"{lib:.3f} ms); kernel C {ms_c:.3f} ms on {card_line()}")
    log(f"  plan: {_plan_line(L, dev, h, rows)}; registers of kernels A-C: "
        f"{_registers_line(registers, 'ABC')}")

    # kernel D at the full-band training shape: both designs, bound, plain
    # version and cuDNN's backward
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    block = _block_bwd_plan(L, dev, h, rows)
    ms_d = cuda_ms(lambda: L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh),
                   iters=10)
    ms_block = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(
        gates, h_seq, c_seq, gout, w_hh, block), iters=3)
    plain_d = cuda_ms(lambda: L.lstm_scan_bwd_reference_tm(
        gates, h_seq, c_seq, gout, w_hh), iters=2)
    lib_fwd, lib_both = library_lstm_train_ms(gates, w_hh, gout)
    b_d, by_d = bound(t_len, rows, h, streams=11, products=2)
    log(f"kernel D at T={t_len} rows={rows} H={h} (full band, training "
        f"batch): {ms_d:.3f} ms, {1e3 * ms_d / t_len:.2f} us a step (the "
        f"single-block design {ms_block:.3f} ms; bound {b_d:.4f} ms by {by_d}; "
        f"plain {plain_d:.3f} ms; cuDNN LSTM backward {lib_both - lib_fwd:.3f} "
        f"ms) on {card_line()}")
    log(f"  plan: {_bwd_plan_line(L, dev, h, rows)}; registers "
        f"{_registers_line(registers, 'D')}")
    return dict(ms=ms_d, single_block_ms=ms_block, plain_ms=plain_d,
                bound_ms=b_d, bound_by=by_d, library_ms=lib_both - lib_fwd,
                plan=dataclasses.asdict(L.card_bwd_scan_plan(dev, h, rows)))


def phase_padded_hidden(dev):
    """Every scan wrapper of the model paths at hidden sizes the kernels do
    not take as they are (H=100 and 200, zero-padded by the wrappers), T=64,
    40 rows, against its plain version within the kernel limits."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for h in PADDED_HIDDEN:
        _lstm_wrappers_vs_plain(L, dev, gen, h, T_CHUNK, 40)
        _gru_wrappers_vs_plain(G, dev, gen, h, T_CHUNK, 40)


def _lstm_wrappers_vs_plain(L, dev, gen, h, t_len, rows):
    """The LSTM forward, carry, training forward and backward wrappers at
    (H, T, rows) against their plain versions within the kernel limits, and
    C's h == A's h bit for bit."""
    tag = f"H={h} T={t_len} rows={rows}"
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    c0 = torch.randn(rows, h, generator=gen, device=dev)
    with torch.no_grad():
        err_a = (L.lstm_scan_tm(gates, w_hh, False, torch.float32)
                 - L.lstm_scan_reference_tm(gates, w_hh)).abs()
        h_a = L.lstm_scan_tm(gates, w_hh)
        got_b = L.lstm_scan_carry_tm(gates, w_hh, h0, c0, True,
                                     torch.float32)
    want_b = L.lstm_scan_carry_reference_tm(gates, w_hh, h0, c0, True)
    err_b = max((x - y).abs().max().item() for x, y in zip(got_b, want_b))
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    p_c = L.lstm_scan_train_reference_tm(gates, w_hh)[1]
    err_c = (c_seq.float() - p_c.float()).abs()
    dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh)
    p_dg = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh)
    err_d = (dg.float() - p_dg.float()).abs()
    peak = p_dg.float().abs().max().item()
    # the layer with the projection inside (kernel F), sub-band input width
    x = torch.randn(t_len, rows, SB_FEATURES, generator=gen, device=dev)
    layer = (_uniform(gen, dev, (SB_FEATURES, 4 * h), h ** -0.5),
             _uniform(gen, dev, (h, 4 * h), h ** -0.5),
             _uniform(gen, dev, (4 * h,), h ** -0.5))
    with torch.no_grad():
        err_f = (L.lstm_layer_tm(x, *layer, True, torch.float32)
                 - L.lstm_layer_reference_tm(x, *layer, True)).abs()
    torch.cuda.synchronize()
    hp, route, _ = L._forward_route(h, rows, dev)
    hf, route_f, _ = L.layer_route(h, SB_FEATURES, rows, dev)
    log(f"LSTM {tag}: A max|err| {err_a.max().item():.3e} mean "
        f"{err_a.mean().item():.3e}; B (reverse, from a state) "
        f"{err_b:.3e}; C c_seq {err_c.max().item():.3e}, h == A bitwise "
        f"{torch.equal(h_seq, h_a)}; D "
        f"{err_d.max().item():.3e} mean {err_d.mean().item():.3e} (peak "
        f"{peak:.3f}); F (reverse, F={SB_FEATURES}) "
        f"{err_f.max().item():.3e} mean {err_f.mean().item():.3e}; A-C at "
        f"{hp} units ({ROUTE_NAMES[route]}), F at {hf} "
        f"({ROUTE_NAMES[route_f]}), D: "
        f"{_describe_bwd(L.card_bwd_scan_plan(dev, -(-h // 16) * 16, rows))}")
    check(err_f.max().item() < KERNEL_MAX_ABS
          and err_f.mean().item() < KERNEL_MEAN_ABS,
          f"lstm_layer_tm vs plain at {tag}")
    check(err_a.max().item() < KERNEL_MAX_ABS
          and err_a.mean().item() < KERNEL_MEAN_ABS
          and err_b < KERNEL_MAX_ABS
          and err_c.max().item() < 8 * KERNEL_MAX_ABS
          and err_c.mean().item() < 8 * KERNEL_MEAN_ABS
          and err_d.max().item() < BWD_MAX_REL * peak
          and err_d.mean().item() < BWD_MEAN_REL * peak
          and torch.equal(h_seq, h_a),
          f"LSTM kernels vs plain, and C h == A h bitwise, at {tag}")


def _gru_wrappers_vs_plain(G, dev, gen, h, t_len, rows):
    """The GRU forward, carry and backward wrappers at (H, T, rows) against
    their plain versions within the kernel limits."""
    tag = f"H={h} T={t_len} rows={rows}"
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    with torch.no_grad():
        err_f = (G.gru_scan_tm(gx, w_g, b_g, False, torch.float32)
                 - G.gru_scan_reference_tm(gx, w_g, b_g)).abs()
        got_c = G.gru_scan_carry_tm(gx, w_g, b_g, h0, True, torch.float32)
        h_g = G.gru_scan_tm(gx, w_g, b_g)
    want_c = G.gru_scan_carry_reference_tm(gx, w_g, b_g, h0, True)
    err_gc = max((x - y).abs().max().item() for x, y in zip(got_c, want_c))
    dgx, dw, db = G.gru_scan_bwd_tm(gx, h_g, gout, w_g, b_g)
    p_dgx, p_dw, p_db = G.gru_scan_bwd_reference_tm(gx, h_g, gout, w_g, b_g)
    err_g = (dgx.float() - p_dgx.float()).abs()
    peak_g = p_dgx.float().abs().max().item()
    rel_w, rel_b = _rel_norm(dw, p_dw), _rel_norm(db, p_db)
    torch.cuda.synchronize()
    hp, route, _ = G._forward_route(h, rows, dev)
    log(f"GRU {tag}: forward max|err| {err_f.max().item():.3e} mean "
        f"{err_f.mean().item():.3e}; carry (reverse, from h0) "
        f"{err_gc:.3e}; backward dgx {err_g.max().item():.3e} mean "
        f"{err_g.mean().item():.3e} (peak {peak_g:.3f}), dW_hh "
        f"{rel_w:.3e}, db_hh {rel_b:.3e}; forward at {hp} units "
        f"({ROUTE_NAMES[route]}), backward: "
        f"{_describe_bwd(G.card_bwd_scan_plan(dev, -(-h // 16) * 16, rows))}")
    check(err_f.max().item() < KERNEL_MAX_ABS
          and err_f.mean().item() < GRU_FWD_MEAN_ABS
          and err_gc < KERNEL_MAX_ABS
          and err_g.max().item() < BWD_MAX_REL * peak_g
          and err_g.mean().item() < BWD_MEAN_REL * peak_g
          and rel_w < BWD_DW_REL and rel_b < BWD_DW_REL,
          f"GRU kernels vs plain at {tag}")


def phase_block_forwards(dev):
    """The single-block forward route (csrc/lstm_scan_block.cu,
    csrc/gru_scan_block.cu, and kernel F's csrc/lstm_layer_block.cu), which
    kernel F takes where no cluster holds H and the scan wrappers take
    where its modelled time beats the streamed cluster's (phase 23), or
    within ops.lstm.single_block_forwards(): bit for bit against the
    cluster entries where both run (LSTM H=512, GRU H=640, forward and
    reverse, bf16 and fp32 out, from a state; kernel F's in phase 12); every
    model-path scan wrapper and lstm_layer_tm at LSTM H=640 and 768 and GRU
    H=768 on the single-block route against its plain version within the
    kernel limits, with the launch counts set to 0 around them; and each
    scan entry at H=768, T=195, 18 rows against its plain version, with its
    time beside bound, plain version and cuDNN. Returns the entries'
    numbers for the kernels line and their launches."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    t_len, rows = T_CHUNK, 40

    def both_routes(run):
        """run() on the card's route and on the single-block route."""
        with torch.no_grad():
            got = run()
            with L.single_block_forwards():
                blk = run()
        torch.cuda.synchronize()
        return got, blk

    h = FB_HIDDEN                                  # LSTM: clusters of 16
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    c0 = torch.randn(rows, h, generator=gen, device=dev)
    for reverse in (False, True):
        for out_dtype in (torch.bfloat16, torch.float32):
            got, blk = both_routes(lambda: (
                L.lstm_scan_tm(gates, w_hh, reverse, out_dtype),
                *L.lstm_scan_carry_tm(gates, w_hh, h0, c0, reverse, out_dtype)))
            check(all(torch.equal(x, y) for x, y in zip(got, blk)),
                  f"LSTM single-block A, B == clusters bitwise (H={h}, "
                  f"reverse={reverse}, {out_dtype})")
        got, blk = both_routes(lambda: L.lstm_scan_train_tm(gates, w_hh,
                                                            reverse))
        check(all(torch.equal(x, y) for x, y in zip(got, blk)),
              f"LSTM single-block C == cluster C bitwise (H={h}, "
              f"reverse={reverse})")
    log(f"LSTM single-block forwards (A, B from a state, C) == the clusters "
        f"bitwise at H={h} T={t_len} rows={rows}, forward and reverse, bf16 "
        f"and fp32 out")
    h = 640                                        # GRU: clusters of 16
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    for reverse in (False, True):
        for out_dtype in (torch.bfloat16, torch.float32):
            got, blk = both_routes(lambda: (
                G.gru_scan_tm(gx, w_g, b_g, reverse, out_dtype),
                *G.gru_scan_carry_tm(gx, w_g, b_g, h0, reverse, out_dtype)))
            check(all(torch.equal(x, y) for x, y in zip(got, blk)),
                  f"GRU single-block forward, carry == clusters bitwise "
                  f"(H={h}, reverse={reverse}, {out_dtype})")
    log(f"GRU single-block forward and carry == the clusters bitwise at H={h} "
        f"T={t_len} rows={rows}, forward and reverse, bf16 and fp32 out; "
        f"the cluster plan there: {_plan_line(G, dev, h, rows)}")
    del gates, gx

    # the route itself: every model-path wrapper where no resident cluster
    # fits, on the single-block route
    L.reset_launch_counts()
    with L.single_block_forwards():
        for h in BLOCK_HIDDEN:
            _lstm_wrappers_vs_plain(L, dev, gen, h, t_len, rows)
        _gru_wrappers_vs_plain(G, dev, gen, BLOCK_HIDDEN[-1], t_len, rows)
    launches = {k: L.launch_counts[k] for k in (
        "lstm_scan_fwd_block", "lstm_scan_fwd_carry_block",
        "lstm_scan_fwd_train_block", "lstm_layer_fwd_block",
        "gru_scan_fwd_block", "gru_scan_fwd_carry_block")}
    log(f"launches of the single-block forwards at LSTM H={BLOCK_HIDDEN} and "
        f"GRU H={BLOCK_HIDDEN[-1]}: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched by the wrappers at an H no resident "
              f"cluster holds")

    # each entry at H=768, the full-band training shape's T and rows
    h, t_len, rows = BLOCK_HIDDEN[-1], TRAIN_T, TRAIN_BATCH
    card = card_line()
    with L.single_block_forwards():
        return _block_entries(L, G, dev, gen, h, t_len, rows, card), launches


def _block_entries(L, G, dev, gen, h, t_len, rows, card):
    """Each single-block forward at (H, T, rows) against its plain version,
    timed beside its bound, its plain version's time and cuDNN's; their
    numbers for the kernels line."""
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    zeros = torch.zeros(rows, h, device=dev)
    with torch.no_grad():
        err_a = (L.lstm_scan_tm(gates, w_hh, False, torch.float32)
                 - L.lstm_scan_reference_tm(gates, w_hh)).abs().max().item()
        err_b = max((x - y).abs().max().item() for x, y in zip(
            L.lstm_scan_carry_tm(gates, w_hh, zeros, zeros, False,
                                 torch.float32),
            L.lstm_scan_carry_reference_tm(gates, w_hh, zeros, zeros)))
    err_c = max((x.float() - y.float()).abs().max().item() for x, y in zip(
        L.lstm_scan_train_tm(gates, w_hh),
        L.lstm_scan_train_reference_tm(gates, w_hh)))
    check(err_a < KERNEL_MAX_ABS and err_b < KERNEL_MAX_ABS
          and err_c < 8 * KERNEL_MAX_ABS,
          f"LSTM single-block forwards vs plain at H={h} T={t_len} "
          f"rows={rows}")
    with torch.no_grad():
        ms_a = cuda_ms(lambda: L.lstm_scan_tm(gates, w_hh), iters=5)
        ms_b = cuda_ms(lambda: L.lstm_scan_carry_tm(gates, w_hh, zeros,
                                                    zeros), iters=5)
    ms_c = cuda_ms(lambda: L.lstm_scan_train_tm(gates, w_hh), iters=5)
    plain_a = cuda_ms(lambda: L.lstm_scan_reference_tm(gates, w_hh), iters=2)
    plain_b = cuda_ms(lambda: L.lstm_scan_carry_reference_tm(
        gates, w_hh, zeros, zeros), iters=2)
    plain_c = cuda_ms(lambda: L.lstm_scan_train_reference_tm(gates, w_hh),
                      iters=2)
    lib_a = library_lstm_ms(gates, w_hh)
    lib_c = library_lstm_train_ms(gates, w_hh, torch.randn(
        t_len, rows, h, generator=gen, device=dev).to(torch.bfloat16))[0]
    b_a, by_a = bound(t_len, rows, h)
    b_b, by_b = bound(t_len, rows, h, extra_bytes=4 * rows * h * 4)
    b_c, by_c = bound(t_len, rows, h, streams=6)
    log(f"LSTM single-block forwards at T={t_len} rows={rows} H={h}: A "
        f"{ms_a:.3f} ms (max|err| {err_a:.3e}), B in one chunk {ms_b:.3f} ms "
        f"({err_b:.3e}), C {ms_c:.3f} ms ({err_c:.3e}); bounds {b_a:.4f} / "
        f"{b_b:.4f} / {b_c:.4f} ms; plain {plain_a:.3f} / {plain_b:.3f} / "
        f"{plain_c:.3f} ms; cuDNN LSTM {lib_a:.3f} ms, training-mode forward "
        f"{lib_c:.3f} ms on {card}")
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        err_f = (G.gru_scan_tm(gx, w_g, b_g, False, torch.float32)
                 - G.gru_scan_reference_tm(gx, w_g, b_g)).abs().max().item()
        err_g = max((x - y).abs().max().item() for x, y in zip(
            G.gru_scan_carry_tm(gx, w_g, b_g, zeros, False, torch.float32),
            G.gru_scan_carry_reference_tm(gx, w_g, b_g, zeros)))
        ms_f = cuda_ms(lambda: G.gru_scan_tm(gx, w_g, b_g), iters=5)
        ms_g = cuda_ms(lambda: G.gru_scan_carry_tm(gx, w_g, b_g, zeros),
                       iters=5)
    check(err_f < KERNEL_MAX_ABS and err_g < KERNEL_MAX_ABS,
          f"GRU single-block forwards vs plain at H={h} T={t_len} rows={rows}")
    plain_f = cuda_ms(lambda: G.gru_scan_reference_tm(gx, w_g, b_g), iters=2)
    plain_g = cuda_ms(lambda: G.gru_scan_carry_reference_tm(gx, w_g, b_g,
                                                            zeros), iters=2)
    lib_f = library_gru_ms(gx, w_g, b_g)
    b_f, by_f = bound(t_len, rows, h, streams=4, gates=3,
                      extra_bytes=3 * h * 4)
    b_g2, by_g2 = bound(t_len, rows, h, streams=4, gates=3,
                        extra_bytes=3 * h * 4 + 2 * rows * h * 4)
    log(f"GRU single-block forwards at T={t_len} rows={rows} H={h}: forward "
        f"{ms_f:.3f} ms (max|err| {err_f:.3e}), carry in one chunk "
        f"{ms_g:.3f} ms ({err_g:.3e}); bounds {b_f:.4f} / {b_g2:.4f} ms; plain "
        f"{plain_f:.3f} / {plain_g:.3f} ms; cuDNN GRU {lib_f:.3f} ms on {card}")
    kernels = {
        "lstm_scan_fwd_block": dict(max_abs_err=err_a, ms=ms_a,
                                    plain_ms=plain_a, bound_ms=b_a,
                                    bound_by=by_a, library_ms=lib_a),
        "lstm_scan_fwd_carry_block": dict(max_abs_err=err_b, ms=ms_b,
                                          plain_ms=plain_b, bound_ms=b_b,
                                          bound_by=by_b, library_ms=lib_a),
        "lstm_scan_fwd_train_block": dict(max_abs_err=err_c, ms=ms_c,
                                          plain_ms=plain_c, bound_ms=b_c,
                                          bound_by=by_c, library_ms=lib_c),
        "gru_scan_fwd_block": dict(max_abs_err=err_f, ms=ms_f,
                                   plain_ms=plain_f, bound_ms=b_f,
                                   bound_by=by_f, library_ms=lib_f),
        "gru_scan_fwd_carry_block": dict(max_abs_err=err_g, ms=ms_g,
                                         plain_ms=plain_g, bound_ms=b_g2,
                                         bound_by=by_g2, library_ms=lib_f)}
    return kernels


# Phase 23: the streamed cluster forwards (csrc/lstm_scan.cu and
# csrc/gru_scan.cu, entries ending in `_stream`), the route of kernels A-C
# and of the GRU forward where no resident cluster holds H.
STREAM_HIDDEN = {"lstm": (640, 768, 1024), "gru": (768, 1024)}
FORCED_HIDDEN = {"lstm": (384, 512), "gru": (384, 640)}
STREAM_TIMED_H = 768
STREAM_ENTRIES = {"lstm": ("lstm_scan_fwd_stream", "lstm_scan_fwd_carry_stream",
                           "lstm_scan_fwd_train_stream"),
                  "gru": ("gru_scan_fwd_stream", "gru_scan_fwd_carry_stream")}
# The two model paths through them: FullSubNet+ whose sub-band LSTM has 768
# units, FullSubNet v1-GRU whose full-band GRU has 1024; one training step of
# each at STREAM_STEP_BATCH x 1 s; the 30 s v1-GRU request under a gates
# limit below its full-band gates (11.5 MB), so that both GRUs take the
# carry kernels.
STREAM_SB_HIDDEN, STREAM_FB_HIDDEN = 768, 1024
STREAM_REQUEST_SECONDS, STREAM_LONG_SECONDS = 10, 30
STREAM_STEP_BATCH, STREAM_STEP_SAMPLES = 4, 16000
STREAM_GRU_GATES_LIMIT = 8 << 20


def _stream_registers(reports):
    """{"stream A bf16": "... registers, ... spilled", ...} for the streamed
    instances lstm_stream_kernel<OutT, CARRY, STREAM_C> and
    gru_stream_kernel<OutT, CARRY>, from ptxas's reports."""
    found, name, spill = {}, None, ""
    out_type = {"13__nv_bfloat16": "bf16", "f": "fp32"}
    for line in "\n".join(reports.get(s, "") for s in (
            "lstm_scan", "gru_scan")).splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            a = re.search(r"lstm_stream_kernelI(13__nv_bfloat16|f)Lb([01])ELb"
                          r"([01])E", line)
            g = re.search(r"gru_stream_kernelI(13__nv_bfloat16|f)Lb([01])E",
                          line)
            if a:
                kernel = ("C" if a.group(3) == "1" else
                          "B" if a.group(2) == "1" else "A")
                name = f"stream {kernel} {out_type[a.group(1)]}"
            elif g:
                name = (f"stream GRU {'carry' if g.group(2) == '1' else 'fwd'}"
                        f" {out_type[g.group(1)]}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _stream_identities(dev, L):
    """Each streamed entry, forward and reverse, bf16 and fp32 out (B from a
    random state), bit for bit against the single block at STREAM_HIDDEN
    (the wrappers' route there) and, under ops.lstm.streamed_forwards(),
    against the resident cluster at FORCED_HIDDEN (the planner's resident
    k-steps and two), T=T_CHUNK x 40 rows; each comparison's streamed run
    counted, once an entry."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.scripts import perf_stream_scan as PS
    t_len, rows = T_CHUNK, 40
    for kind in ("lstm", "gru"):
        M = L if kind == "lstm" else G
        cases = [(h, "single block", None) for h in STREAM_HIDDEN[kind]]
        cases += [(h, "resident cluster", res) for h in FORCED_HIDDEN[kind]
                  for res in (None, 2)]
        for h, ref, resident in cases:
            gates, weights, state = PS.inputs(kind, t_len, rows, h, dev,
                                              seed=SEED + h + (resident or 1))
            if ref == "single block":
                check(M._forward_route(h, rows, dev)[1] == "_stream",
                      f"the {kind} route at H={h} is the streamed cluster")
                ref_ctx, got_ctx = L.single_block_forwards, contextlib.nullcontext
            else:
                ref_ctx = contextlib.nullcontext
                got_ctx = lambda res=resident: L.streamed_forwards(res)  # noqa: E731
            n = 0
            for entry in PS.ENTRIES[kind]:
                for reverse in (False, True):
                    for out_dtype in (torch.bfloat16, torch.float32):
                        if entry == "train" and out_dtype != torch.bfloat16:
                            continue
                        with ref_ctx():
                            want = PS.run(kind, entry, gates, weights, state,
                                          reverse, out_dtype)
                        before = dict(L.launch_counts)
                        with got_ctx():
                            got = PS.run(kind, entry, gates, weights, state,
                                         reverse, out_dtype)
                        torch.cuda.synchronize()
                        launched = _launched(L.launch_counts, before)
                        name = {"fwd": 0, "carry": 1, "train": 2}[entry]
                        check(launched == {STREAM_ENTRIES[kind][name]: 1},
                              f"{kind} {entry} at H={h} launched its streamed "
                              f"entry once (got {launched})")
                        check(all(torch.equal(x, y) for x, y in zip(got, want)),
                              f"{STREAM_ENTRIES[kind][name]} == the {ref} "
                              f"bitwise (H={h}, reverse={reverse}, "
                              f"{out_dtype}, resident {resident})")
                        n += 1
            log(f"{kind} streamed entries == the {ref} bitwise at H={h} "
                f"T={t_len} rows={rows}: {n} calls (forward and reverse, "
                f"bf16 and fp32 out, the carry from a state"
                f"{'' if ref == 'single block' else f', resident {resident}'})")


def _stream_bounds(kind, t_len, rows, h):
    """(bound ms, by) of each streamed entry at (T, rows, H), as the single
    blocks' (the state of B and of the GRU carry read and written once)."""
    if kind == "lstm":
        return (bound(t_len, rows, h),
                bound(t_len, rows, h, extra_bytes=4 * rows * h * 4),
                bound(t_len, rows, h, streams=6))
    return (bound(t_len, rows, h, streams=4, gates=3, extra_bytes=3 * h * 4),
            bound(t_len, rows, h, streams=4, gates=3,
                  extra_bytes=3 * h * 4 + 2 * rows * h * 4))


def _stream_times(dev, L, G, gen, t_len, rows, card):
    """Each streamed entry at (H=STREAM_TIMED_H, T, rows) against its plain
    version within the kernel limits (C's h == A's bitwise), timed beside
    the single block (in turns: stream, block, block, stream), the bound,
    the plain version and cuDNN, with the plan and its modelled step; fails
    where the plan takes the streamed cluster and it is not the faster."""
    h = STREAM_TIMED_H
    out = {}
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    c0 = torch.randn(rows, h, generator=gen, device=dev)
    calls = {"lstm_scan_fwd_stream": (
                 lambda: L.lstm_scan_tm(gates, w_hh),
                 lambda: (L.lstm_scan_tm(gates, w_hh, False, torch.float32),),
                 lambda: (L.lstm_scan_reference_tm(gates, w_hh),)),
             "lstm_scan_fwd_carry_stream": (
                 lambda: L.lstm_scan_carry_tm(gates, w_hh, h0, c0),
                 lambda: L.lstm_scan_carry_tm(gates, w_hh, h0, c0, False,
                                              torch.float32),
                 lambda: L.lstm_scan_carry_reference_tm(gates, w_hh, h0, c0)),
             "lstm_scan_fwd_train_stream": (
                 lambda: L.lstm_scan_train_tm(gates, w_hh),
                 lambda: L.lstm_scan_train_tm(gates, w_hh),
                 lambda: L.lstm_scan_train_reference_tm(gates, w_hh))}
    lib = library_lstm_ms(gates, w_hh)
    lib_c = library_lstm_train_ms(gates, w_hh)[0]
    libs = {"lstm_scan_fwd_stream": lib, "lstm_scan_fwd_carry_stream": lib,
            "lstm_scan_fwd_train_stream": lib_c}
    instances = {"lstm_scan_fwd_stream": (0, 0, 0),
                 "lstm_scan_fwd_carry_stream": (0, 1, 0),
                 "lstm_scan_fwd_train_stream": (0, 0, 1)}
    out.update(_time_entries(dev, L, L, calls, libs, instances,
                             _stream_bounds("lstm", t_len, rows, h), t_len,
                             rows, h, card))
    with torch.no_grad():
        check(torch.equal(L.lstm_scan_train_tm(gates, w_hh)[0],
                          L.lstm_scan_tm(gates, w_hh)),
              f"lstm_scan_fwd_train_stream h == lstm_scan_fwd_stream h "
              f"bitwise (T={t_len} rows={rows})")
    del gates, calls
    w_g, b_g = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                _uniform(gen, dev, (3 * h,), h ** -0.5))
    gx = torch.randn(t_len, rows, 3 * h, generator=gen,
                     device=dev).to(torch.bfloat16)
    calls = {"gru_scan_fwd_stream": (
                 lambda: G.gru_scan_tm(gx, w_g, b_g),
                 lambda: (G.gru_scan_tm(gx, w_g, b_g, False, torch.float32),),
                 lambda: (G.gru_scan_reference_tm(gx, w_g, b_g),)),
             "gru_scan_fwd_carry_stream": (
                 lambda: G.gru_scan_carry_tm(gx, w_g, b_g, h0),
                 lambda: G.gru_scan_carry_tm(gx, w_g, b_g, h0, False,
                                             torch.float32),
                 lambda: G.gru_scan_carry_reference_tm(gx, w_g, b_g, h0))}
    lib = library_gru_ms(gx, w_g, b_g)
    out.update(_time_entries(
        dev, L, G, calls, dict.fromkeys(calls, lib),
        {"gru_scan_fwd_stream": (0, 0), "gru_scan_fwd_carry_stream": (0, 1)},
        _stream_bounds("gru", t_len, rows, h), t_len, rows, h, card))
    return out


def _time_entries(dev, L, M, calls, libs, instances, bounds, t_len, rows, h,
                  card):
    """_stream_times for the entries of one module M: calls maps an entry to
    (its timed call, its fp32-output call, the plain version's call)."""
    out = {}
    for (name, (timed, f32, plain)), (b_ms, by) in zip(calls.items(), bounds):
        with torch.no_grad():
            got = f32()
        want = plain()
        errs = [(x.float() - y.float()).abs() for x, y in zip(got, want)]
        max_err = max(e.max().item() for e in errs)
        mean_err = max(e.mean().item() for e in errs)
        # kernel C's c sequence: 8x the limits of h (C_PEAK); the GRU's mean
        # its own (GRU_FWD_MEAN_ABS)
        scale = 8 if name.endswith("train_stream") else 1
        mean_limit = (GRU_FWD_MEAN_ABS if name.startswith("gru")
                      else KERNEL_MEAN_ABS)
        check(max_err < scale * KERNEL_MAX_ABS
              and mean_err < scale * mean_limit,
              f"{name} vs plain at H={h} T={t_len} rows={rows}")
        del got, want, errs

        def block():
            with L.single_block_forwards():
                return timed()

        with torch.no_grad():
            rounds = [cuda_ms(timed, iters=3), cuda_ms(block, iters=2),
                      cuda_ms(block, iters=2), cuda_ms(timed, iters=3)]
        ms, ms_block = min(rounds[0], rounds[3]), min(rounds[1:3])
        plain_ms = cuda_ms(plain, iters=2)
        plan = M.card_stream_plan(dev, h, rows, instances[name])
        route = M._forward_route(h, rows, dev, instances[name])[1]
        log(f"{name} at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
            f"{1e3 * ms / t_len / plan.waves:.3f} us a step a wave (modelled "
            f"{plan.step_us:.3f}); single block {ms_block:.3f} ms (rounds "
            f"{' '.join(f'{r:.3f}' for r in rounds)}); max|err| {max_err:.3e} "
            f"mean {mean_err:.3e}; bound {b_ms:.4f} ms by {by}; plain "
            f"{plain_ms:.3f} ms; cuDNN {libs[name]:.3f} ms; route "
            f"{ROUTE_NAMES[route]}; plan C={plan.cluster} x {plan.rows}, "
            f"{plan.resident} k-steps resident, {plan.stages} stages, "
            f"{plan.clusters} ({plan.active}), {plan.waves} waves, "
            f"{plan.smem_bytes} B on {card}")
        if route == "_stream":
            check(ms < ms_block, f"{name} at T={t_len} rows={rows}: the plan "
                  f"takes the streamed cluster, which must beat the single "
                  f"block ({ms:.3f} against {ms_block:.3f} ms)")
        out[name] = dict(max_abs_err=max_err, ms=ms, single_block_ms=ms_block,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=libs[name], scan_route=route,
                         plan=dataclasses.asdict(plan))
    return out


def stream_model_paths():
    """FullSubNet+ with a 768-unit sub-band LSTM and FullSubNet v1-GRU with
    a 1024-unit full-band GRU, numpy-made weights from SEED in the JAX
    layout: the model paths of the streamed forwards."""
    from generative_audio_torch import models as M
    from generative_audio_torch.train import EnhanceTrainConfig
    from generative_audio_torch.utils import convert
    plus_cfg = M.FullSubNetPlusConfig(sb_model_hidden_size=STREAM_SB_HIDDEN)
    plus = ModelPath(
        name=f"FullSubNet+ sb H={STREAM_SB_HIDDEN}",
        model_cls=M.FullSubNetPlus, config=plus_cfg,
        sd=convert.convert_fullsubnet_plus(
            convert.random_fullsubnet_plus_params(plus_cfg, seed=SEED + 31)),
        mode="mag_complex_full_band_crm_mask", n_inputs=3,
        fwd="lstm_scan_fwd_stream", carry="lstm_scan_fwd_carry_stream",
        per_forward=2, per_long_forward=0,
        train_config=lambda dtype: EnhanceTrainConfig(
            model=M.FullSubNetPlusConfig(
                sb_model_hidden_size=STREAM_SB_HIDDEN,
                num_groups_in_drop_band=2), compute_dtype=dtype),
        per_step={"lstm_scan_fwd_train_stream": 2, "lstm_scan_bwd_stream": 2})
    gru_cfg = M.FullSubNetConfig(sequence_model="GRU",
                                 fb_model_hidden_size=STREAM_FB_HIDDEN,
                                 num_groups_in_drop_band=1)
    gru = ModelPath(
        name=f"FullSubNet v1-GRU fb H={STREAM_FB_HIDDEN}",
        model_cls=M.FullSubNet, config=gru_cfg,
        sd=convert.convert_fullsubnet(
            convert.random_fullsubnet_params(gru_cfg, seed=SEED + 32), "GRU"),
        mode="full_band_crm_mask", n_inputs=1,
        fwd="gru_scan_fwd_stream", carry="gru_scan_fwd_carry_stream",
        per_forward=2, per_long_forward=0,
        train_config=lambda dtype: EnhanceTrainConfig(
            model_type="fullsubnet",
            model_v1=M.FullSubNetConfig(sequence_model="GRU",
                                        fb_model_hidden_size=STREAM_FB_HIDDEN),
            compute_dtype=dtype),
        # the sub-band GRU's backward named by the route at its rows
        per_step={"gru_scan_fwd_stream": 2,
                  routed("gru_scan_fwd", STREAM_STEP_BATCH * (257 // 2)): 2,
                  "gru_scan_bwd_stream": 2,
                  routed("gru_scan_bwd", STREAM_STEP_BATCH * (257 // 2)): 2,
                  "gru_scan_bwd_dwhh": 4})
    return plus, gru


def _stream_path(dev, path, counts, gates_limit, serve_extra):
    """One model path of the streamed forwards: the 1 s reference (card
    against the float32 model on the CPU), then, with the counts set to 0
    around each, a 10 s request, a 30 s request under `gates_limit`
    (chunked; against the unchunked request on the card) and one bf16
    training step through EnhanceTrainer (_stream_step), each with its
    exact launches. Returns the launches of the three."""
    from generative_audio_torch.ops import lstm as L
    model = path.model(torch.bfloat16, dev)
    phase_reference(dev, path, model)
    total = dict.fromkeys(counts, 0)
    rng = np.random.default_rng(SEED + 33)

    def counted(what, fn, expected):
        L.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        launched = {k: n for k, n in counts.items() if n}
        check(launched == expected, f"{path.name} {what} launched {expected} "
              f"(got {launched})")
        for k, n in launched.items():
            total[k] += n
        return result

    noisy = (rng.standard_normal(STREAM_REQUEST_SECONDS * 16000) * 0.1
             ).astype(np.float32)
    inf = path.inferencer(model, dev)
    t0 = time.perf_counter()
    out = counted(f"{STREAM_REQUEST_SECONDS} s request",
                  lambda: inf.enhance(noisy),
                  {path.fwd: path.per_forward, **serve_extra})
    wall = (time.perf_counter() - t0) * 1e3
    check(out.shape == noisy.shape and np.isfinite(out).all(),
          f"{path.name} {STREAM_REQUEST_SECONDS} s request: shape and finite")
    noisy = (rng.standard_normal(STREAM_LONG_SECONDS * 16000) * 0.1
             ).astype(np.float32)
    whole = inf.enhance(noisy)
    chunked = path.inferencer(path.model(torch.bfloat16, dev,
                                         gates_bytes_limit=gates_limit), dev)
    L.reset_launch_counts()
    long_out = chunked.enhance(noisy)
    torch.cuda.synchronize()
    launched = {k: n for k, n in counts.items() if n}
    for k, n in launched.items():
        total[k] += n
    rel = np.abs(long_out - whole).max() / np.abs(whole).max()
    check(launched.get(path.carry, 0) > 0 and path.fwd not in launched,
          f"{path.name}: the {STREAM_LONG_SECONDS} s request took "
          f"{path.carry} (got {launched})")
    check(np.isfinite(long_out).all() and rel < PATH_REL,
          f"{path.name}: {STREAM_LONG_SECONDS} s chunked vs unchunked within "
          f"{PATH_REL}")
    for k, n in _stream_step(dev, path, counts).items():
        total[k] += n
    log(f"{path.name}: {STREAM_REQUEST_SECONDS} s request {wall:.2f} ms (rtf "
        f"{inf.last_rtf:.5f}); {STREAM_LONG_SECONDS} s under a "
        f"{gates_limit / 2 ** 20:g} MiB gates limit, chunked vs "
        f"unchunked max|err|/peak {rel:.3e}; launches "
        f"{dict((k, n) for k, n in total.items() if n)} on {card_line()}")
    return total


def _stream_step(dev, path, counts):
    """One bf16 EnhanceTrainer step of STREAM_STEP_BATCH x 1 s on `path`
    with the counts set to 0 around it, its launches exactly the path's
    per_step, its loss against the float32 model's on the CPU. Returns the
    step's launches."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import (
        EnhanceTrainer, enhance_loss_fn, init_enhance_state)
    noisy_b, clean_b = (torch.from_numpy(x) for x in _noise_batch(
        SEED + 34, STREAM_STEP_BATCH, STREAM_STEP_SAMPLES))
    trainer = EnhanceTrainer(path.train_config("bfloat16"), seed=SEED,
                             pretrained_state_dict=path.sd, device=dev)
    L.reset_launch_counts()
    t0 = time.perf_counter()
    loss = trainer.train_epoch([(noisy_b.to(dev), clean_b.to(dev))])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launched = {k: n for k, n in counts.items() if n}
    check(launched == path.per_step, f"{path.name} training step launched "
          f"{path.per_step} (got {launched})")
    del trainer
    cfg = path.train_config("float32")
    state = init_enhance_state(cfg, SEED, "cpu")
    state.model.load_state_dict(path.sd)
    with torch.no_grad():
        want = enhance_loss_fn(state.model, noisy_b, clean_b, cfg).item()
    del state
    loss_rel = abs(loss - want) / abs(want)
    log(f"{path.name}: a bf16 step of {STREAM_STEP_BATCH} x "
        f"{STREAM_STEP_SAMPLES / 16000:.0f} s in {wall:.1f} ms (the first, "
        f"plans and packing included): loss {loss:.6f} against the CPU's "
        f"float32 {want:.6f} (rel {loss_rel:.3e}); launches {launched}")
    check(np.isfinite(loss) and loss_rel < TRAIN_LOSS_REL,
          f"{path.name}: bf16 step loss vs float32 within {TRAIN_LOSS_REL}")
    return launched


def phase_streamed_forwards(dev, registers):
    """Phase 23: the streamed cluster forwards. (a) Each `_stream` entry bit
    for bit against the single block at LSTM H=640, 768, 1024 and GRU
    H=768, 1024 and, under ops.lstm.streamed_forwards(), against the
    resident cluster at LSTM H=384, 512 and GRU H=384, 640; (b) each
    against its plain version and timed at H=768 x T=195 x 18 rows and
    H=768 x T=628 x 2056 rows beside the single block, the bound, the plain
    version and cuDNN, the streamed route the faster wherever the plan
    takes it; (c) the model paths: FullSubNet+ with a 768-unit sub-band
    LSTM and v1-GRU with a 1024-unit full-band GRU, each a 10 s request, a
    chunked 30 s request and a training step with exact launches (its
    backward through phase 24's streamed backwards), card against CPU.
    Returns the entries' numbers (the 18-row shape; the 2056-row one under
    "sub_band") and the launches of the streamed forwards and backwards on
    (c)'s paths."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"streamed instances: {_registers_line(registers, 's')}")
    _stream_identities(dev, L)
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    kernels = _stream_times(dev, L, G, gen, TRAIN_T, TRAIN_BATCH, card)
    torch.cuda.empty_cache()        # the sub-band shape takes tens of GiB
    for name, numbers in _stream_times(dev, L, G, gen, T_FRAMES, ROWS,
                                       card).items():
        kernels[name]["sub_band"] = numbers
    torch.cuda.empty_cache()
    plus, gru = stream_model_paths()
    launches = dict.fromkeys(L.launch_counts, 0)
    for path, limit, extra in ((plus, LONG_CLIP_GATES_LIMIT, {}),
                               (gru, STREAM_GRU_GATES_LIMIT,
                                {routed("gru_scan_fwd", ROWS // 8): 2})):
        for k, n in _stream_path(dev, path, L.launch_counts, limit,
                                 extra).items():
            launches[k] += n
    launches = {k: launches[k] for k in (*STREAM_ENTRIES["lstm"],
                                         *STREAM_ENTRIES["gru"],
                                         *BWD_STREAM_ENTRIES.values())}
    log(f"launches of the streamed entries on their model paths: {launches}; "
        f"phase 23 {time.perf_counter() - t0:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"{name} launched on its model path")
    return kernels, launches


# Phase 24: the streamed cluster backwards (csrc/scan_bwd_stream.cu,
# lstm_scan_bwd_stream and gru_scan_bwd_stream), the route of kernel D and
# of the GRU backward scan above H=512 where the streamed cluster's modelled
# waves x step beat the single block's, and the only one above the single
# blocks' H (LSTM 1024, GRU 1072).
BWD_STREAM_ENTRIES = {"lstm": "lstm_scan_bwd_stream",
                      "gru": "gru_scan_bwd_stream"}
BWD_STREAM_BLOCK_H = {"lstm": (640, 768, 1024), "gru": (640, 1024, 1072)}
BWD_STREAM_FORCED_H = (384, 512)
BWD_STREAM_PLAIN_H = (1536, 2304)
# (H, rows) of the timings at T=TRAIN_T: the single block's widest kernel-D
# shape, a 768-unit sub-band LSTM's training batch, the forwards' limit
BWD_STREAM_TIMED = ((1024, TRAIN_BATCH), (768, TRAIN_ROWS),
                    (2304, TRAIN_BATCH))
BWD_STREAM_TIMED_KEYS = ("", "sub_band", "h2304")
# the FullSubNet+ whose sub-band LSTM no single block trains
BWD_STREAM_SB_HIDDEN = 1536


def _bwd_stream_registers(reports):
    """{"bwd stream D tile": "... registers, ... spilled", ...} for the
    instances bwd_stream_kernel<NG, TILE> of csrc/scan_bwd_stream.cu, from
    ptxas's report."""
    found, name, spill = {}, None, ""
    for line in reports.get("scan_bwd_stream", "").splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            m = re.search(r"bwd_stream_kernelILi([34])ELb([01])E", line)
            if m:
                kind = "D" if m.group(1) == "4" else "GRU backward"
                name = (f"bwd stream {kind} "
                        f"{'tile' if m.group(2) == '1' else 'slices'}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _counted(L, entry, fn, n=1):
    """fn()'s result, after checking that it launched `entry` n times and
    nothing else."""
    before = dict(L.launch_counts)
    out = fn()
    torch.cuda.synchronize()
    launched = _launched(L.launch_counts, before)
    check(launched == {entry: n}, f"{entry} launched {n} times (got "
          f"{launched})")
    return out


def _bwd_stream_identities(dev):
    """Each streamed backward, forward-reversed and not, at T_CHUNK x 40
    rows: the wrapper's route (the streamed cluster) bit for bit against the
    single block at BWD_STREAM_BLOCK_H; and, at BWD_STREAM_FORCED_H, the
    resident cluster (the route there) against forced streamed plans: the
    planner's, with no slot resident, and with the dgates tile held the
    other way. The GRU's dgx, dhn and every db_hh partial."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    t_len, rows = T_CHUNK, 40
    for kind, M in (("lstm", L), ("gru", G)):
        entry = BWD_STREAM_ENTRIES[kind]
        for h in (*BWD_STREAM_BLOCK_H[kind], *BWD_STREAM_FORCED_H):
            inputs = PB._INPUTS[kind](t_len, rows, h, dev, seed=SEED + 40 + h)
            route = M.card_bwd_scan_plan(dev, h, rows)
            if h in BWD_STREAM_FORCED_H:
                check(route.design == "cluster", f"the {kind} backward at H={h} "
                      f"takes the resident cluster")
                ref, name = route, "the resident cluster"
                p = M.card_bwd_stream_plan(dev, h, rows)
                streamed = [p, M.card_bwd_stream_plan(dev, h, rows, 0),
                            PB.stream_plan(kind, h, rows, p.cluster, p.rows,
                                           None, p.stages, not p.tile, dev)]
            else:
                check(route.design == "stream", f"the {kind} backward at H={h} "
                      f"takes the streamed cluster (got {_describe_bwd(route)})")
                ref, name = _block_bwd_plan(M, dev, h, rows), "the single block"
                streamed = [route]
            n = 0
            for reverse in (False, True):
                want = PB.run(kind, inputs, ref, reverse)
                for plan in streamed:
                    if plan is None:
                        continue
                    got = _counted(L, entry, lambda: PB.run(
                        kind, inputs, plan, reverse))
                    check(all(torch.equal(x, y) for x, y in zip(got, want)),
                          f"{entry} == {name} bitwise (H={h}, reverse="
                          f"{reverse}, {_describe_bwd(plan)})")
                    n += 1
            log(f"{entry} == {name} bitwise at H={h} T={t_len} rows={rows}: "
                f"{n} calls (forward-reversed and not; "
                f"{'; '.join(_describe_bwd(p) for p in streamed if p)})")
            del inputs


def _bwd_stream_vs_plain(dev):
    """Each streamed backward, the route above the single blocks' H,
    against its plain version within the backward limits at
    BWD_STREAM_PLAIN_H (T=16, 18 rows; the GRU's db_hh within BWD_DW_REL
    of the norm)."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    t_len, rows = 16, TRAIN_BATCH
    for kind, M in (("lstm", L), ("gru", G)):
        entry = BWD_STREAM_ENTRIES[kind]
        for h in BWD_STREAM_PLAIN_H:
            inputs = PB._INPUTS[kind](t_len, rows, h, dev, seed=SEED + 50 + h)
            plan = M.card_bwd_scan_plan(dev, h, rows)
            check(plan.design == "stream", f"the {kind} backward at H={h} "
                  f"takes the streamed cluster")
            if kind == "lstm":
                got = (_counted(L, entry,
                                    lambda: L.lstm_scan_bwd_tm(*inputs)),)
                want = (L.lstm_scan_bwd_reference_tm(*inputs),)
            else:
                got = _counted(L, entry,
                                   lambda: G.gru_scan_bwd_streams_tm(*inputs))
                want = G.gru_scan_bwd_streams_reference_tm(*inputs)
            errs = []
            for x, y in zip(got[:2], want[:2]):
                err = (x.float() - y.float()).abs()
                peak = y.float().abs().max().item()
                errs.append(err.max().item() / peak)
                check(torch.isfinite(x.float()).all().item()
                      and err.max().item() < BWD_MAX_REL * peak
                      and err.mean().item() < BWD_MEAN_REL * peak,
                      f"{entry} vs plain within {BWD_MAX_REL}/{BWD_MEAN_REL} "
                      f"of the peak at H={h}")
            rel_b = _rel_norm(got[2], want[2]) if kind == "gru" else 0.0
            check(rel_b < BWD_DW_REL, f"{entry} db_hh vs plain within "
                  f"{BWD_DW_REL} at H={h}")
            log(f"{entry} vs plain at H={h} T={t_len} rows={rows}: max|err|/"
                f"peak {', '.join(f'{e:.3e}' for e in errs)}"
                f"{f'; db_hh {rel_b:.3e} of the norm' if kind == 'gru' else ''}"
                f"; {_describe_bwd(plan)}")
            del inputs, got, want


def _bwd_stream_times(dev, card):
    """Each streamed backward at BWD_STREAM_TIMED (T=TRAIN_T) against its
    plain version within the backward limits, timed beside the single block
    where it holds H (in turns: stream, block, block, stream), the bound,
    the plain version and cuDNN's backward, with the plan and its modelled
    step; fails where the plan takes the streamed cluster and it is not the
    faster. Returns each entry's numbers by shape."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    out = {entry: {} for entry in BWD_STREAM_ENTRIES.values()}
    t_len = TRAIN_T
    for kind, M in (("lstm", L), ("gru", G)):
        entry = BWD_STREAM_ENTRIES[kind]
        for (h, rows), key in zip(BWD_STREAM_TIMED, BWD_STREAM_TIMED_KEYS):
            inputs = PB._INPUTS[kind](t_len, rows, h, dev, seed=SEED + 60 + h)
            plan = M.card_bwd_scan_plan(dev, h, rows)
            # the single blocks hold H up to 1024 (kernel D's dc in
            # registers) and 1072 (the GRU's shared memory)
            holds = (L.bwd_smem_bytes(h) if kind == "lstm"
                     else G.bwd_block_smem_bytes(h)) <= L.SMEM_LIMIT and (
                kind == "gru" or h <= 1024)
            block = _block_bwd_plan(M, dev, h, rows) if holds else None
            if kind == "lstm":
                def timed():
                    return L.lstm_scan_bwd_tm(*inputs)

                def plain():
                    return L.lstm_scan_bwd_reference_tm(*inputs)

                gates, _, _, gout, w_hh = inputs
                lib_f, lib_b = library_lstm_train_ms(gates, w_hh, gout)
                b_ms, by = bound(t_len, rows, h, streams=11, products=2)
            else:
                def timed():
                    return G.gru_scan_bwd_streams_tm(*inputs)

                def plain():
                    return G.gru_scan_bwd_streams_reference_tm(*inputs)

                gates, _, gout, w_hh, b_hh = inputs
                lib_f, lib_b = library_gru_train_ms(gates, w_hh, b_hh, gout)
                b_ms, by = bound(t_len, rows, h, streams=9, products=2,
                                 gates=3, extra_bytes=2 * 3 * h * 4)
            got = timed() if kind == "gru" else (timed(),)
            want = plain() if kind == "gru" else (plain(),)
            err = (got[0].float() - want[0].float()).abs()
            peak = want[0].float().abs().max().item()
            max_err = err.max().item()
            check(max_err < BWD_MAX_REL * peak
                  and err.mean().item() < BWD_MEAN_REL * peak,
                  f"{entry} route vs plain at H={h} rows={rows}")
            del got, want, err

            def in_block():
                return PB.run(kind, inputs, block)

            if holds:
                rounds = [cuda_ms(timed, iters=3), cuda_ms(in_block, iters=2),
                          cuda_ms(in_block, iters=2), cuda_ms(timed, iters=3)]
                ms, ms_block = min(rounds[0], rounds[3]), min(rounds[1:3])
            else:
                rounds = [cuda_ms(timed, iters=3)]
                ms, ms_block = rounds[0], None
            plain_ms = cuda_ms(plain, iters=1, warmup=0)
            log(f"{entry} route at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
                f"{1e3 * ms / t_len / plan.waves:.3f} us a step a wave "
                f"(modelled {plan.step_us:.3f}); single block "
                f"{f'{ms_block:.3f} ms' if holds else 'does not hold H'} "
                f"(rounds {' '.join(f'{r:.3f}' for r in rounds)}); max|err| "
                f"{max_err:.3e} (peak {peak:.3f}); bound {b_ms:.4f} ms by {by}; "
                f"plain {plain_ms:.3f} ms; cuDNN backward {lib_b - lib_f:.3f} "
                f"ms (forward + backward {lib_b:.3f} less the training "
                f"forward {lib_f:.3f}); {_describe_bwd(plan)} on {card}")
            if plan.design == "stream" and holds:
                check(ms < ms_block, f"{entry} at H={h} rows={rows}: the plan "
                      f"takes the streamed cluster, which must beat the "
                      f"single block ({ms:.3f} against {ms_block:.3f} ms)")
            numbers = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=by,
                           library_ms=lib_b - lib_f,
                           single_block_ms=ms_block, scan_route=plan.design,
                           plan=dataclasses.asdict(plan))
            if key:
                out[entry][key] = numbers
            else:
                out[entry].update(numbers)
            del inputs
            torch.cuda.empty_cache()
    return out


def _bwd_stream_model_step(dev):
    """FullSubNet+ whose sub-band LSTM has BWD_STREAM_SB_HIDDEN units, which
    no single block of kernel D trains: one bf16 EnhanceTrainer step of
    STREAM_STEP_BATCH x 1 s with exact launches (kernel C's and kernel D's
    streamed clusters, twice each), its loss against the float32 model's on
    the CPU. Returns the step's launches."""
    from generative_audio_torch import models as M
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import EnhanceTrainConfig
    from generative_audio_torch.utils import convert
    h = BWD_STREAM_SB_HIDDEN
    cfg = M.FullSubNetPlusConfig(sb_model_hidden_size=h)
    path = ModelPath(
        name=f"FullSubNet+ sb H={h}", model_cls=M.FullSubNetPlus, config=cfg,
        sd=convert.convert_fullsubnet_plus(
            convert.random_fullsubnet_plus_params(cfg, seed=SEED + 36)),
        mode="mag_complex_full_band_crm_mask", n_inputs=3,
        fwd="lstm_scan_fwd_stream", carry="lstm_scan_fwd_carry_stream",
        per_forward=2, per_long_forward=0,
        train_config=lambda dtype: EnhanceTrainConfig(
            model=M.FullSubNetPlusConfig(sb_model_hidden_size=h,
                                         num_groups_in_drop_band=2),
            compute_dtype=dtype),
        per_step={"lstm_scan_fwd_train_stream": 2,
                  "lstm_scan_bwd_stream": 2})
    return _stream_step(dev, path, L.launch_counts)


def phase_streamed_backwards(dev, registers):
    """Phase 24: the streamed cluster backwards. (a) Each `_stream`
    backward bit for bit against the single block at LSTM H=640, 768, 1024
    and GRU H=640, 1024, 1072 (its route there) and against the resident
    cluster under forced streamed plans at H=384 and 512; (b) against its
    plain version at H=1536 and 2304; (c) timed at H=1024 x 18, H=768 x
    2304 and H=2304 x 18 rows (T=195) beside the single block where it
    holds H, the bound, the plain version and cuDNN's backward, the
    streamed route the faster wherever the plan takes it; (d) one bf16
    training step of a FullSubNet+ with a 1536-unit sub-band LSTM with
    exact launches, its loss against the CPU's float32 (phase 23's model
    paths train through both entries too). Returns the entries' numbers
    and their launches on (d)'s path."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"streamed backward instances: {_registers_line(registers, 'b')}")
    _bwd_stream_identities(dev)
    _bwd_stream_vs_plain(dev)
    kernels = _bwd_stream_times(dev, card_line())
    launches = _bwd_stream_model_step(dev)
    log(f"launches of the streamed backwards on phase 24's model path: "
        f"{launches}; phase 24 {time.perf_counter() - t0:.1f} s")
    return kernels, {k: launches.get(k, 0)
                     for k in BWD_STREAM_ENTRIES.values()}


# Phase 25: kernels E and F as streamed clusters (csrc/lstm_staged_stream.cu,
# lstm_scan_fwd_unrolled_stream and lstm_layer_fwd_stream), their route
# above H=512 where no resident cluster of lstm_scan_staged.cu holds H.
STAGED_STREAM_ENTRIES = ("lstm_scan_fwd_unrolled_stream",
                         "lstm_layer_fwd_stream")
STAGED_BLOCK_H = (640, 768, 1024)       # against the single blocks
STAGED_FORCED_H = (384, 512)            # against the clusters, forced
STAGED_PLAIN_H = (1536, 2304)           # against the plain versions
STAGED_TIMED_H = 768
STAGED_E_T = 192                        # T=195 cut to whole groups of 4
# E's largest H: 2304 at K=2, 2048 at K=4 (one group of 4 steps of gates
# beside the h buffers); the path's unrolled forwards run at these H
STAGED_E_LARGEST = {2: 2304, 4: 2048}
STAGED_PATH_H = (768, 1536)


def _staged_stream_registers(reports):
    """{"E stream K=2": "... registers, ... spilled", "F stream bf16": ...}
    for the instances of csrc/lstm_staged_stream.cu, from ptxas's report."""
    found, name, spill = {}, None, ""
    out_type = {"13__nv_bfloat16": "bf16", "f": "fp32"}
    for line in reports.get("lstm_staged_stream", "").splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            e = re.search(r"lstm_unrolled_stream_kernelILi(\d)E", line)
            f = re.search(r"lstm_layer_stream_kernelI(13__nv_bfloat16|f)E",
                          line)
            if e:
                name = f"E stream K={e.group(1)}"
            elif f:
                name = f"F stream {out_type[f.group(1)]}"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _staged_identities(dev, L, PU, PS):
    """Each streamed entry bit for bit, T=T_CHUNK x 40 rows: against its
    single block at STAGED_BLOCK_H (E at K=2 and 4, also against kernel A's
    route there, lstm_scan_fwd_stream; F at F=34 and F=H, forward and
    reverse, bf16 and fp32 out), and, under ops.lstm.streamed_forwards()
    (the planner's resident k-steps and two), against the cluster at
    STAGED_FORCED_H (E also against lstm_scan_fwd_stream, forced)."""
    t_len, rows = T_CHUNK, 40
    for h in (*STAGED_BLOCK_H, *STAGED_FORCED_H):
        forced = h in STAGED_FORCED_H
        gates, w = PS.gates_inputs(t_len, rows, h, dev, seed=SEED + 70 + h)
        n = 0
        for k in L.UNROLL_STEPS:
            route = L.unrolled_route(h, k, rows, dev)[1]
            check(route == ("" if forced else "_stream"), f"kernel E's route "
                  f"at H={h} K={k} (got {route!r})")
            with torch.no_grad():
                if forced:
                    want = (PU.lstm_unrolled(gates, w, block_t=k),
                            L.lstm_scan_tm(gates, w))
                    for res in (None, 2):
                        with L.streamed_forwards(res):
                            got = _counted(L, STAGED_STREAM_ENTRIES[0],
                                           lambda: PU.lstm_unrolled(
                                               gates, w, block_t=k))
                            a_stream = _counted(L, "lstm_scan_fwd_stream",
                                                lambda: L.lstm_scan_tm(gates,
                                                                       w))
                        check(torch.equal(got, want[0])
                              and torch.equal(got, want[1])
                              and torch.equal(got, a_stream),
                              f"lstm_scan_fwd_unrolled_stream == the cluster "
                              f"and lstm_scan_fwd_stream bitwise (H={h} K={k} "
                              f"resident {res})")
                        n += 1
                else:
                    got = _counted(L, STAGED_STREAM_ENTRIES[0],
                                   lambda: PU.lstm_unrolled(gates, w,
                                                            block_t=k))
                    with L.single_block_forwards():
                        blk = PU.lstm_unrolled(gates, w, block_t=k)
                    a_stream = _counted(L, "lstm_scan_fwd_stream",
                                        lambda: L.lstm_scan_tm(gates, w))
                    check(torch.equal(got, blk) and torch.equal(got, a_stream),
                          f"lstm_scan_fwd_unrolled_stream == its single block "
                          f"and lstm_scan_fwd_stream bitwise (H={h} K={k})")
                    n += 1
        del gates
        for f in (SB_FEATURES, h):
            inputs = PS.layer_inputs(t_len, rows, f, h, dev,
                                     seed=SEED + 80 + h + f)
            for reverse in (False, True):
                for out_dtype in (torch.bfloat16, torch.float32):
                    with torch.no_grad():
                        if forced:
                            want = L.lstm_layer_tm(*inputs, reverse, out_dtype)
                            for res in (None, 2):
                                with L.streamed_forwards(res):
                                    got = _counted(
                                        L, STAGED_STREAM_ENTRIES[1],
                                        lambda: L.lstm_layer_tm(
                                            *inputs, reverse, out_dtype))
                                check(torch.equal(got, want),
                                      f"lstm_layer_fwd_stream == lstm_layer_"
                                      f"fwd bitwise (H={h} F={f} reverse="
                                      f"{reverse} {out_dtype} resident {res})")
                                n += 1
                        else:
                            got = _counted(L, STAGED_STREAM_ENTRIES[1],
                                           lambda: L.lstm_layer_tm(
                                               *inputs, reverse, out_dtype))
                            with L.single_block_forwards():
                                want = L.lstm_layer_tm(*inputs, reverse,
                                                       out_dtype)
                            check(torch.equal(got, want),
                                  f"lstm_layer_fwd_stream == lstm_layer_fwd_"
                                  f"block bitwise (H={h} F={f} reverse="
                                  f"{reverse} {out_dtype})")
                            n += 1
            del inputs
        torch.cuda.synchronize()
        log(f"kernels E and F streamed == the "
            f"{'clusters (forced)' if forced else 'single blocks'} bitwise at "
            f"H={h} T={t_len} rows={rows}: {n} calls (E at K=2 and 4, also "
            f"== lstm_scan_fwd_stream; F at F={SB_FEATURES} and {h}, forward "
            f"and reverse, bf16 and fp32 out"
            f"{', resident the planner' + chr(39) + 's and 2' if forced else ''})")


def _staged_vs_plain(dev, L, PU, PS, card):
    """Each streamed entry against its plain version within the kernel
    limits at STAGED_PLAIN_H (E at its largest H where below), T=16, 18
    rows; and kernel F's step at H=1536 and 2304 with F=34 and F=H (W_ih^T
    and W_hh^T together beyond the 50 MB L2 at H=2304), T=64."""
    t_len, rows = 16, TRAIN_BATCH
    for h in STAGED_PLAIN_H:
        for k in L.UNROLL_STEPS:
            he = min(h, STAGED_E_LARGEST[k])
            gates, w = PS.gates_inputs(t_len, rows, he, dev,
                                       seed=SEED + 90 + he)
            got = _counted(L, STAGED_STREAM_ENTRIES[0],
                           lambda: PU.lstm_unrolled(gates, w, block_t=k))
            err = (got.float() - PU.lstm_unrolled_reference(gates, w).float()
                   ).abs()
            check(torch.isfinite(got.float()).all().item()
                  and err.max().item() < KERNEL_MAX_ABS
                  and err.mean().item() < KERNEL_MEAN_ABS,
                  f"lstm_scan_fwd_unrolled_stream vs plain at H={he} K={k}")
            log(f"lstm_scan_fwd_unrolled_stream K={k} vs plain at H={he} "
                f"T={t_len} rows={rows}: max|err| {err.max().item():.3e} mean "
                f"{err.mean().item():.3e}; plan "
                f"{L.unrolled_route(he, k, rows, dev)[2]}")
            del gates
        for f in (SB_FEATURES, h):
            inputs = PS.layer_inputs(t_len, rows, f, h, dev,
                                     seed=SEED + 95 + h + f)
            with torch.no_grad():
                got = _counted(L, STAGED_STREAM_ENTRIES[1],
                               lambda: L.lstm_layer_tm(*inputs, False,
                                                       torch.float32))
            err = (got - L.lstm_layer_reference_tm(*inputs)).abs()
            check(torch.isfinite(got).all().item()
                  and err.max().item() < KERNEL_MAX_ABS
                  and err.mean().item() < KERNEL_MEAN_ABS,
                  f"lstm_layer_fwd_stream vs plain at H={h} F={f}")
            x64 = PS.layer_inputs(T_CHUNK, rows, f, h, dev, seed=SEED + 96)
            with torch.no_grad():
                ms = cuda_ms(lambda: L.lstm_layer_tm(*x64), iters=3)
            plan = L.layer_route(h, f, rows, dev)[2]
            log(f"lstm_layer_fwd_stream vs plain at H={h} F={f} T={t_len} "
                f"rows={rows}: max|err| {err.max().item():.3e} mean "
                f"{err.mean().item():.3e}; at T={T_CHUNK}: {ms:.3f} ms, "
                f"{1e3 * ms / T_CHUNK:.2f} us a step (modelled "
                f"{plan.step_us:.2f}), W_ih^T + W_hh^T "
                f"{4 * h * (f + h) * 2 / 1e6:.1f} MB; plan {plan} on {card}")
            del inputs, x64


def _staged_times(dev, L, PU, PS, gen, rows, card):
    """Each streamed entry at H=STAGED_TIMED_H and `rows` rows (E at
    T=STAGED_E_T or T_FRAMES, both K; F at TRAIN_T or T_FRAMES, F=34 and
    F=H) against its plain version, timed beside its single block (in
    turns: stream, block, block, stream), the bound, the plain version and
    cuDNN's nn.LSTM, with the plan; fails where the plan takes the streamed
    cluster and it is not the faster. Returns both entries' numbers."""
    h = STAGED_TIMED_H
    out = {}
    t_len = STAGED_E_T if rows == TRAIN_BATCH else T_FRAMES
    gates, w = PS.gates_inputs(t_len, rows, h, dev, seed=SEED + 100 + rows)
    numbers = {}
    with torch.no_grad():
        for k in L.UNROLL_STEPS:
            got = PU.lstm_unrolled(gates, w, block_t=k)
            want = PU.lstm_unrolled_reference(gates, w)
            err = (got.float() - want.float()).abs()
            max_err = err.max().item()
            check(max_err < KERNEL_MAX_ABS
                  and err.mean().item() < KERNEL_MEAN_ABS,
                  f"lstm_scan_fwd_unrolled_stream vs plain at H={h} K={k} "
                  f"rows={rows}")
            del got, want, err

            def timed(k=k):
                return PU.lstm_unrolled(gates, w, block_t=k)

            def block(k=k):
                with L.single_block_forwards():
                    return PU.lstm_unrolled(gates, w, block_t=k)

            iters = 1 if rows > TRAIN_BATCH else 2
            rounds = [cuda_ms(timed, iters=3), cuda_ms(block, iters=iters),
                      cuda_ms(block, iters=iters), cuda_ms(timed, iters=3)]
            ms, ms_block = min(rounds[0], rounds[3]), min(rounds[1:3])
            hp, route, plan = L.unrolled_route(h, k, rows, dev)
            log(f"lstm_scan_fwd_unrolled_stream K={k} at T={t_len} "
                f"rows={rows} H={h}: {ms:.3f} ms, "
                f"{1e3 * ms / t_len / plan.waves:.3f} us a step a wave "
                f"(modelled {plan.step_us:.3f}); single block {ms_block:.3f} "
                f"ms ({L.unrolled_block_rows(h, k)} rows a block; rounds "
                f"{' '.join(f'{r:.3f}' for r in rounds)}); max|err| "
                f"{max_err:.3e}; route {ROUTE_NAMES[route]}; plan {plan} on "
                f"{card}")
            if route == "_stream":
                check(ms < ms_block, f"lstm_scan_fwd_unrolled_stream K={k} "
                      f"at rows={rows}: the plan takes the streamed cluster, "
                      f"which must beat the single block ({ms:.3f} against "
                      f"{ms_block:.3f} ms)")
            numbers[k] = dict(max_abs_err=max_err, ms=ms,
                              single_block_ms=ms_block, scan_route=route,
                              plan=dataclasses.asdict(plan))
        plain = cuda_ms(lambda: PU.lstm_unrolled_reference(gates, w),
                        iters=1)
        lib = library_lstm_ms(gates, w)
    b_ms, by = bound(t_len, rows, h)
    log(f"lstm_scan_fwd_unrolled_stream at T={t_len} rows={rows} H={h}: "
        f"bound {b_ms:.4f} ms by {by}; plain {plain:.3f} ms; cuDNN LSTM "
        f"{lib:.3f} ms on {card}")
    out[STAGED_STREAM_ENTRIES[0]] = dict(
        **numbers[2], plain_ms=plain, bound_ms=b_ms, bound_by=by,
        library_ms=lib, t=t_len, k4=numbers[4])
    del gates

    t_len = TRAIN_T if rows == TRAIN_BATCH else T_FRAMES
    layers = {}
    for f in (SB_FEATURES, h):
        inputs = PS.layer_inputs(t_len, rows, f, h, dev, seed=SEED + 110 + f)
        with torch.no_grad():
            got = L.lstm_layer_tm(*inputs, False, torch.float32)
            err = (got - L.lstm_layer_reference_tm(*inputs)).abs()
            max_err = err.max().item()
            check(max_err < KERNEL_MAX_ABS
                  and err.mean().item() < KERNEL_MEAN_ABS,
                  f"lstm_layer_fwd_stream vs plain at H={h} F={f} "
                  f"rows={rows}")
            del got, err

            def timed():
                return L.lstm_layer_tm(*inputs)

            def block():
                with L.single_block_forwards():
                    return L.lstm_layer_tm(*inputs)

            rounds = [cuda_ms(timed, iters=3), cuda_ms(block, iters=2),
                      cuda_ms(block, iters=2), cuda_ms(timed, iters=3)]
            ms, ms_block = min(rounds[0], rounds[3]), min(rounds[1:3])
            plain = cuda_ms(lambda: L.lstm_layer_reference_tm(*inputs),
                            iters=1)
            lib = library_layer_ms(*inputs)
        b_ms, by = _layer_bound(t_len, rows, f, h)
        hp, route, plan = L.layer_route(h, f, rows, dev)
        log(f"lstm_layer_fwd_stream F={f} at T={t_len} rows={rows} H={h}: "
            f"{ms:.3f} ms, {1e3 * ms / t_len / plan.waves:.3f} us a step a "
            f"wave (modelled {plan.step_us:.3f}); single block "
            f"{ms_block:.3f} ms (rounds {' '.join(f'{r:.3f}' for r in rounds)})"
            f"; max|err| {max_err:.3e}; bound {b_ms:.4f} ms by {by}; plain "
            f"{plain:.3f} ms; cuDNN nn.LSTM({f}, {h}) {lib:.3f} ms; route "
            f"{ROUTE_NAMES[route]}; plan {plan} on {card}")
        if route == "_stream":
            check(ms < ms_block, f"lstm_layer_fwd_stream F={f} at rows={rows}"
                  f": the plan takes the streamed cluster, which must beat "
                  f"the single block ({ms:.3f} against {ms_block:.3f} ms)")
        layers[f] = dict(max_abs_err=max_err, ms=ms, single_block_ms=ms_block,
                         plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=lib, scan_route=route,
                         plan=dataclasses.asdict(plan))
        del inputs
    out[STAGED_STREAM_ENTRIES[1]] = dict(**layers[SB_FEATURES], t=t_len,
                                         f_equals_h=layers[h])
    return out


def _staged_path(dev, L, PU):
    """The path, with the counts set to 0 before each part and read just
    after: lstm_layer_tm over the real sub-band stack of the 768-unit and
    the 1536-unit FullSubNet+ (phase 12's hook on one batch-8 x 10 s
    request: layer 1 F=34, layer 2 F=H), both layers through the entry
    point against the model's own hoisted stack within the layer path's
    limits, two launches of lstm_layer_fwd_stream each; then lstm_unrolled
    and lstm_scan_tm(block_t=k) at H=768, 1536 and E's largest H, bit for
    bit against kernel A's route. Returns the launches."""
    from generative_audio_torch import models as M
    from generative_audio_torch.utils import convert
    launches = dict.fromkeys(STAGED_STREAM_ENTRIES, 0)
    for h in STAGED_PATH_H:
        cfg = M.FullSubNetPlusConfig(sb_model_hidden_size=h)
        path = ModelPath(
            name=f"FullSubNet+ sb H={h}", model_cls=M.FullSubNetPlus,
            config=cfg, sd=convert.convert_fullsubnet_plus(
                convert.random_fullsubnet_plus_params(cfg, seed=SEED + 37)),
            mode="mag_complex_full_band_crm_mask", n_inputs=3,
            fwd="lstm_scan_fwd_stream", carry="lstm_scan_fwd_carry_stream",
            per_forward=2, per_long_forward=0, train_config=None, per_step={})
        x, hoisted, weights = _sub_band_stack(dev, path)
        check(tuple(x.shape) == (T_FRAMES, ROWS, SB_FEATURES),
              f"the sub-band input of {path.name}")
        L.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            y1 = L.lstm_layer_tm(x, *weights[0])
            y2 = L.lstm_layer_tm(y1, *weights[1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: n for k, n in L.launch_counts.items() if n}
        check(launched == {"lstm_layer_fwd_stream": 2}, f"{path.name}: the "
              f"two layers launched lstm_layer_fwd_stream twice and nothing "
              f"else (got {launched})")
        launches["lstm_layer_fwd_stream"] += 2
        err = (y2.float() - hoisted.float()).abs()
        log(f"lstm_layer_tm x 2 over {path.name}'s sub-band input "
            f"[{T_FRAMES}, {ROWS}, {SB_FEATURES}] vs the model's hoisted "
            f"stack: max|err| {err.max().item():.3e} mean "
            f"{err.mean().item():.3e}; {wall:.1f} ms the two layers; plans "
            f"{L.layer_route(h, SB_FEATURES, ROWS, dev)[2]}, "
            f"{L.layer_route(h, h, ROWS, dev)[2]}")
        check(torch.isfinite(y2.float()).all().item()
              and err.max().item() < LAYER_PATH_MAX_ABS
              and err.mean().item() < LAYER_PATH_MEAN_ABS,
              f"{path.name}: lstm_layer_tm stack vs the hoisted stack within "
              f"{LAYER_PATH_MAX_ABS}/{LAYER_PATH_MEAN_ABS}")
        del x, hoisted, weights, y1, y2, err
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    t_len, rows = T_CHUNK, 40
    for h in sorted({768, 1536, *STAGED_E_LARGEST.values()}):
        w = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        with torch.no_grad():
            want = L.lstm_scan_tm(gates, w)                  # kernel A
            for k in L.UNROLL_STEPS:
                if h > STAGED_E_LARGEST[k]:
                    continue
                L.reset_launch_counts()
                got = (PU.lstm_unrolled(gates, w, block_t=k),
                       L.lstm_scan_tm(gates, w, block_t=k))
                torch.cuda.synchronize()
                launched = {n: c for n, c in L.launch_counts.items() if c}
                check(launched == {"lstm_scan_fwd_unrolled_stream": 2},
                      f"lstm_unrolled and lstm_scan_tm(block_t={k}) at H={h} "
                      f"launched lstm_scan_fwd_unrolled_stream (got "
                      f"{launched})")
                launches["lstm_scan_fwd_unrolled_stream"] += 2
                check(all(torch.equal(g, want) for g in got),
                      f"kernel E streamed K={k} == kernel A's route bitwise "
                      f"(H={h})")
        a_route = L._forward_route(h, rows, dev)[1]
        log(f"lstm_unrolled and lstm_scan_tm(block_t=k) at H={h} T={t_len} "
            f"rows={rows} == lstm_scan_fwd{a_route} bitwise (K="
            f"{', '.join(str(k) for k in L.UNROLL_STEPS if h <= STAGED_E_LARGEST[k])})")
        del gates, want, got
    for k, h in STAGED_E_LARGEST.items():
        above = h + 64
        try:
            L.unrolled_route(above, k, rows, dev)
        except ValueError as e:
            log(f"kernel E at H={above} K={k} refused: {str(e)[:160]} ...")
        else:
            check(False, f"kernel E at H={above} K={k} must be refused")
    return launches


def phase_streamed_staged(dev, registers):
    """Phase 25: kernels E and F as streamed clusters. (a) Each `_stream`
    entry bit for bit against its single block at H=640, 768, 1024 (E at
    K=2 and 4 and against lstm_scan_fwd_stream; F at F=34 and F=H, forward
    and reverse, bf16 and fp32 out) and, under streamed_forwards(), against
    the cluster at H=384 and 512; (b) against its plain version at H=1536
    and 2304 (E at its largest H where below), with F's step at F=H where
    its two weights outgrow L2, and timed at H=768 x 18 rows (E T=192, F
    T=195) and x 2056 rows x T=628 (F=34 and 768) beside the single block,
    the bound, the plain version and cuDNN, the streamed route the faster
    wherever the plan takes it; (c) the path: lstm_layer_tm over the
    sub-band stacks of the 768- and 1536-unit FullSubNet+, and lstm_unrolled
    and lstm_scan_tm(block_t) at H=768, 1536, 2048 and 2304, with exact
    launches. Returns the entries' numbers and their launches on (c)."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_lstm_unroll as PU
    from generative_audio_torch.scripts import perf_staged_scan as PS
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("kernels E and F streamed, instances: " + (", ".join(
        f"{k} {v}" for k, v in sorted(registers.items()) if " stream " in k
        and k[0] in "EF") or "not rebuilt in this run"))
    card = card_line()
    _staged_identities(dev, L, PU, PS)
    _staged_vs_plain(dev, L, PU, PS, card)
    gen = torch.Generator(device=dev).manual_seed(SEED + 39)
    kernels = _staged_times(dev, L, PU, PS, gen, TRAIN_BATCH, card)
    torch.cuda.empty_cache()
    for name, numbers in _staged_times(dev, L, PU, PS, gen, ROWS,
                                       card).items():
        kernels[name]["sub_band"] = numbers
    torch.cuda.empty_cache()
    launches = _staged_path(dev, L, PU)
    log(f"launches of kernels E and F streamed on phase 25's path: "
        f"{launches}; phase 25 {time.perf_counter() - t0:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"{name} launched on its path")
    return kernels, launches


# Phase 26: kernels A and B as wide clusters (csrc/lstm_scan_wide.cu,
# lstm_scan_fwd_wide and lstm_scan_fwd_carry_wide, the products on wgmma),
# the route of both wherever a resident cluster holds H and the wide
# cluster's modelled waves x step beat the resident cluster's
# (ops.lstm.plan_forward): at the sub-band batch (8 x 10 s, 2056 rows) one
# wave of 144 rows a cluster where the resident cluster needs five of 32.
WIDE_ENTRIES = ("lstm_scan_fwd_wide", "lstm_scan_fwd_carry_wide")
# Whether wgmma's fp32 sums equal mma.sync's bit for bit with the k16 steps
# in the same order, as found on an H100: the wide design is held
# bit for bit against the resident cluster while this holds.
WGMMA_EQUALS_MMA_SYNC = True
# (H, T, rows) of the identities: the sub-band batch and its ragged count,
# one 10 s request, the full band's training shape.
WIDE_SHAPES = ((HIDDEN, T_FRAMES, ROWS), (HIDDEN, T_FRAMES, RAGGED_ROWS),
               (HIDDEN, T_FRAMES, ROWS // 8), (FB_HIDDEN, TRAIN_T,
                                                TRAIN_BATCH))


def _wide_registers(reports):
    """{"wide 144 rows": "... registers, ... spilled", ...} for the
    instances lstm_wide_kernel<N> of csrc/lstm_scan_wide.cu (N rows a
    cluster; kernels A and B, both output types), from ptxas's report (the
    registers a thread launches with; the consumers take more by
    setmaxnreg)."""
    found, name, spill = {}, None, ""
    for line in reports.get("lstm_scan_wide", "").splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            w = re.search(r"lstm_wide_kernelILi(\d+)E", line)
            if w:
                name = f"wide {int(w.group(1)):3d} rows"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _wide_plan_line(plan):
    return (f"C={plan.cluster} x {plan.rows} rows, {plan.warpgroups} "
            f"warpgroups, {plan.resident} k-steps resident, "
            f"{plan.stages} stages, {plan.clusters} clusters ({plan.active} "
            f"at once), {plan.waves} waves, {plan.smem_bytes} B")


def _chunked_carry(L, gates, w_hh, h0, c0, reverse, out_dtype):
    """Kernel B over chunks of T_CHUNK steps, the state handed on (from the
    later chunk when reversed): (h sequence, h_T, c_T)."""
    t_len = gates.shape[0]
    out = torch.empty(t_len, gates.shape[1], w_hh.shape[0], dtype=out_dtype,
                      device=gates.device)
    hs, cs = h0, c0
    starts = list(range(0, t_len, T_CHUNK))
    for s in (starts[::-1] if reverse else starts):
        e = min(s + T_CHUNK, t_len)
        out[s:e], hs, cs = L.lstm_scan_carry_tm(gates[s:e], w_hh, hs, cs,
                                                reverse, out_dtype)
    return out, hs, cs


def _wide_identities(dev, L, gen):
    """At each of WIDE_SHAPES, forward and reverse, bf16 and fp32 out: both
    wide entries bit for bit against the resident cluster (kernel B from a
    random state: h, h_T and c_T), kernel B from zero in chunks of T_CHUNK
    against the unchunked forward and its final state, kernel A twice
    against itself, and at fp32 out within the kernel limits of their
    plain versions; each wide run counted. First, whether the wide entries'
    wgmma sums equal the resident cluster's mma.sync sums bit for bit over
    all of them, with the worst difference, which must be
    WGMMA_EQUALS_MMA_SYNC's answer. Returns each entry's largest max and
    mean error against plain."""
    worst = {name: [0.0, 0.0] for name in WIDE_ENTRIES}
    sums = [True, 0.0]       # every wide output == the resident's; worst
    for h, t_len, rows in WIDE_SHAPES:
        w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        h0 = _uniform(gen, dev, (rows, h), 1.0)
        c0 = torch.randn(rows, h, generator=gen, device=dev)
        zero = torch.zeros(rows, h, device=dev)
        n_chunks = -(-t_len // T_CHUNK)
        plan = L.card_wide_plan(dev, h, rows)
        for reverse in (False, True):
            p_a = L.lstm_scan_reference_tm(gates, w_hh, reverse)
            p_b = L.lstm_scan_carry_reference_tm(gates, w_hh, h0, c0, reverse)
            for out_dtype in (torch.bfloat16, torch.float32):
                tag = (f"H={h} T={t_len} rows={rows} reverse={reverse} "
                       f"{out_dtype}")
                with torch.no_grad():
                    with L.resident_forwards():
                        a_res = L.lstm_scan_tm(gates, w_hh, reverse, out_dtype)
                        b_res = L.lstm_scan_carry_tm(gates, w_hh, h0, c0,
                                                     reverse, out_dtype)
                        b_zero = L.lstm_scan_carry_tm(gates, w_hh, zero, zero,
                                                      reverse, out_dtype)
                    with L.wide_forwards():
                        a = _counted(L, WIDE_ENTRIES[0], lambda: (
                            L.lstm_scan_tm(gates, w_hh, reverse, out_dtype)))
                        again = _counted(L, WIDE_ENTRIES[0], lambda: (
                            L.lstm_scan_tm(gates, w_hh, reverse, out_dtype)))
                        b = _counted(L, WIDE_ENTRIES[1], lambda: (
                            L.lstm_scan_carry_tm(gates, w_hh, h0, c0, reverse,
                                                 out_dtype)))
                        chunked = _counted(
                            L, WIDE_ENTRIES[1], lambda: _chunked_carry(
                                L, gates, w_hh, zero, zero, reverse,
                                out_dtype), n_chunks)
                for x, y in zip((a, *b), (a_res, *b_res)):
                    sums[0] = sums[0] and torch.equal(x, y)
                    sums[1] = max(sums[1], (x.float() - y.float()).abs()
                                  .max().item())
                check(torch.equal(a, again), f"two runs of lstm_scan_fwd_wide "
                      f"under one plan bitwise ({tag})")
                check(torch.equal(a, a_res),
                      f"lstm_scan_fwd_wide == lstm_scan_fwd bitwise ({tag})")
                check(all(torch.equal(x, y) for x, y in zip(b, b_res)),
                      f"lstm_scan_fwd_carry_wide == lstm_scan_fwd_carry "
                      f"bitwise: h, h_T, c_T ({tag})")
                check(torch.equal(chunked[0], a_res)
                      and all(torch.equal(x, y) for x, y in
                              zip(chunked[1:], b_zero[1:])),
                      f"lstm_scan_fwd_carry_wide in {n_chunks} chunks of "
                      f"{T_CHUNK} == unchunked bitwise, its state too ({tag})")
                # against the plain versions at fp32 out (bf16 out rounds h
                # once more; it equals the resident cluster's, above)
                for name, got, want in (((WIDE_ENTRIES[0], (a,), (p_a,)),
                                         (WIDE_ENTRIES[1], b, p_b))
                                        if out_dtype == torch.float32 else ()):
                    errs = [(x.float() - y.float()).abs()
                            for x, y in zip(got, want)]
                    mx = max(e.max().item() for e in errs)
                    mean = max(e.mean().item() for e in errs)
                    check(mx < KERNEL_MAX_ABS and mean < KERNEL_MEAN_ABS,
                          f"{name} vs plain within {KERNEL_MAX_ABS}/"
                          f"{KERNEL_MEAN_ABS} ({tag}: {mx:.3e}/{mean:.3e})")
                    worst[name] = [max(worst[name][0], mx),
                                   max(worst[name][1], mean)]
                del a, again, b, chunked, a_res, b_res, b_zero
            del p_a, p_b
        log(f"wide entries == the resident cluster bitwise at H={h} "
            f"T={t_len} rows={rows} (forward and reverse, bf16 and fp32 out, "
            f"B from a state and in {n_chunks} chunks of {T_CHUNK} == "
            f"unchunked); wide plan {_wide_plan_line(plan)}; route "
            f"{L._forward_route(h, rows, dev)[1] or 'resident'}")
        del gates, h0, c0, zero
        torch.cuda.empty_cache()
    log(f"wgmma's fp32 sums == mma.sync's bit for bit (the wide entries "
        f"against the resident cluster at every shape above): {sums[0]}, "
        f"worst |difference| {sums[1]:.3e}")
    check(sums[0] == WGMMA_EQUALS_MMA_SYNC,
          f"wgmma's sums equal mma.sync's: {WGMMA_EQUALS_MMA_SYNC} as found "
          f"before")
    return worst


def _wide_times(dev, L, gen, rows, card):
    """Both wide entries at (H=HIDDEN, T=T_FRAMES, rows), bf16 out as the
    path runs them, timed beside the resident cluster in turns (wide,
    resident, resident, wide), with the plain version, cuDNN, the bound,
    the plan, its modelled step and the route there."""
    h, t_len = HIDDEN, T_FRAMES
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    c0 = torch.randn(rows, h, generator=gen, device=dev)
    library = library_lstm_ms(gates, w_hh)
    out = {}
    calls = {WIDE_ENTRIES[0]: (lambda: L.lstm_scan_tm(gates, w_hh),
                               lambda: L.lstm_scan_reference_tm(gates, w_hh),
                               bound(t_len, rows, h), (0, 0)),
             WIDE_ENTRIES[1]: (lambda: L.lstm_scan_carry_tm(gates, w_hh, h0,
                                                            c0),
                               lambda: L.lstm_scan_carry_reference_tm(
                                   gates, w_hh, h0, c0),
                               bound(t_len, rows, h,
                                     extra_bytes=4 * rows * h * 4), (0, 1))}
    for name, (timed, plain, (b_ms, by), instance) in calls.items():

        def wide():
            with L.wide_forwards():
                return timed()

        def resident():
            with L.resident_forwards():
                return timed()

        with torch.no_grad():
            rounds = [cuda_ms(wide, iters=3), cuda_ms(resident, iters=3),
                      cuda_ms(resident, iters=3), cuda_ms(wide, iters=3)]
            plain_ms = cuda_ms(plain, iters=2)
        ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
        plan = L.card_wide_plan(dev, h, rows)
        res_plan = L.card_scan_plan(dev, h, rows, carry=bool(instance[1]))
        route = L._forward_route(h, rows, dev, (*instance, 0))[1]
        log(f"{name} at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
            f"{1e3 * ms / t_len / plan.waves:.3f} us a step a wave (modelled "
            f"{plan.step_us:.3f}); resident cluster {ms_res:.3f} ms, "
            f"{1e3 * ms_res / t_len / res_plan.waves:.3f} us a step a wave "
            f"(modelled {L.scan_step_us(h, res_plan.cluster, res_plan.rows):.3f}"
            f", {res_plan.waves} waves); rounds "
            f"{' '.join(f'{r:.3f}' for r in rounds)}; bound {b_ms:.4f} ms by "
            f"{by}; plain {plain_ms:.3f} ms; cuDNN {library:.3f} ms; plan "
            f"{_wide_plan_line(plan)}; route "
            f"{'wide' if route == '_wide' else 'resident'}; on {card}")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=library, resident_ms=ms_res,
                         us_a_step=1e3 * ms / t_len / plan.waves,
                         route="wide" if route == "_wide" else "resident",
                         plan=dataclasses.asdict(plan))
    del gates
    torch.cuda.empty_cache()
    return out


def _wide_path(dev, plus):
    """FullSubNet+ on the route, the counts set to 0 around each part: one
    10 s request (257 rows), the batched 8 x 10 s forward (2056 rows) and
    the same batch under LONG_CLIP_GATES_LIMIT (kernel B in chunks at 2056
    rows, against the unchunked forward); each part's launches exactly the
    route's, the two forwards profiled. Returns the parts' launches."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.ops import prepare_input_from_waveform
    model = plus.model(torch.bfloat16, dev)
    total = dict.fromkeys(L.launch_counts, 0)

    def counted(what, fn, expected):
        L.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        launched = {k: n for k, n in L.launch_counts.items() if n}
        check(launched == expected, f"{what} launched {expected}, the "
              f"route's (got {launched})")
        for k, n in launched.items():
            total[k] += n
        return result

    gen = torch.Generator(device=dev).manual_seed(SEED + 260)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    one = prepare_input_from_waveform(wav[:1], 512, 256, 512)[:plus.n_inputs]
    batch = prepare_input_from_waveform(wav, 512, 256, 512)[:plus.n_inputs]
    with torch.inference_mode():
        counted("a 10 s request", lambda: model(*one),
                routed_counts(("lstm_scan_fwd", ROWS // 8, 2)))
        whole = counted("the batched 8 x 10 s forward", lambda: model(*batch),
                        routed_counts(("lstm_scan_fwd", ROWS, 2)))
        _profile(lambda: model(*one), "FullSubNet+ 10 s request on the "
                 "route")
        _profile(lambda: model(*batch), "FullSubNet+ batch 8 x 10 s forward "
                 "on the route")
        chunked_model = plus.model(torch.bfloat16, dev,
                                   gates_bytes_limit=LONG_CLIP_GATES_LIMIT)
        L.reset_launch_counts()
        got = chunked_model(*batch)
        torch.cuda.synchronize()
        launched = {k: n for k, n in L.launch_counts.items() if n}
        carry = routed("lstm_scan_fwd_carry", ROWS)
        check(set(launched) == {carry} and launched[carry] > 0,
              f"the batched 8 x 10 s forward under a "
              f"{LONG_CLIP_GATES_LIMIT >> 20} MiB gates limit took {carry}, "
              f"the route's, alone (got {launched})")
        for k, n in launched.items():
            total[k] += n
        rel = ((got.float() - whole.float()).abs().max()
               / whole.float().abs().max()).item()
    log(f"FullSubNet+ batch 8 x 10 s chunked ({launched}) against unchunked: "
        f"max|err|/peak {rel:.3e}")
    check(torch.isfinite(got).all().item() and rel < PATH_REL,
          f"chunked vs unchunked batched forward within {PATH_REL}")
    return {k: n for k, n in total.items() if n}


def phase_wide_forwards(dev, registers):
    """Phase 26: kernels A and B as wide clusters, the products on wgmma.
    (a) No instance spills; both entries bit for bit against the resident
    cluster at 2056 and a ragged 2047 rows x T=628, 257 rows x 628 and
    H=512 x 18 x 195 (forward and reverse, bf16 and fp32 out, B from a
    state and in 10 chunks of 64 against unchunked, A against a second run
    of itself), within the kernel limits of their plain versions, and the
    answer whether wgmma's sums equal mma.sync's, with the worst
    difference; (b) timed at 2056 and
    257 rows beside the resident cluster, the plain version, cuDNN and the
    bound, with the plan the route weighs and its pick; (c) the path:
    FullSubNet+ on the route, a 10 s request, the batched 8 x 10 s forward
    (both profiled) and that batch chunked, with exact launches. Returns
    the entries' numbers (2056 rows; 257 under "request") and the launches
    of the wide entries on (c)."""
    from generative_audio_torch.ops import lstm as L
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    wide = {k: v for k, v in registers.items() if k.startswith("wide")}
    log(f"wide instances: {_registers_line(wide, 'w')}")
    check(all(v.endswith(" 0/0 B spilled") for v in wide.values()),
          "no wide instance spills")
    gen = torch.Generator(device=dev).manual_seed(SEED + 261)
    worst = _wide_identities(dev, L, gen)
    kernels = _wide_times(dev, L, gen, ROWS, card)
    for name, numbers in _wide_times(dev, L, gen, ROWS // 8, card).items():
        kernels[name]["request"] = numbers
    for name in WIDE_ENTRIES:
        kernels[name]["max_abs_err"], kernels[name]["mean_abs_err"] = \
            worst[name]
    plus, _, _ = model_paths()
    path = _wide_path(dev, plus)
    launches = {name: path.get(name, 0) for name in WIDE_ENTRIES}
    log(f"launches on phase 26's path: {path}; phase 26 "
        f"{time.perf_counter() - t0:.1f} s")
    check(any(launches.values()), "a wide entry launched on phase 26's path")
    return kernels, launches


# Phase 27: kernel D as a wide cluster (csrc/lstm_scan_bwd_wide.cu).
WIDE_BWD_ENTRY = "lstm_scan_bwd_wide"
# (H, T, rows) of the identities: the sub-band training batch and its
# ragged count, the NPPC head's 1024 rows, the full band's training shape.
WIDE_BWD_SHAPES = ((HIDDEN, TRAIN_T, TRAIN_ROWS),
                   (HIDDEN, TRAIN_T, TRAIN_RAGGED_ROWS),
                   (HIDDEN, TRAIN_T, 1024), (FB_HIDDEN, TRAIN_T, TRAIN_BATCH))
WIDE_BWD_STEPS = 4           # (c)'s timed steps of each design, in turns


def _wide_bwd_registers(reports):
    """{"wide D 1x3": "... registers, ... spilled", "wide G U=48 R=192": ...,
    "traced G U=48 R=192": ...} for the instances lstm_bwd_wide_kernel<MT,
    NG> of csrc/lstm_scan_bwd_wide.cu (kernel D) and gru_bwd_wide_kernel<U,
    R, TRACE> of csrc/gru_scan_bwd_wide.cu (the GRU backward; the traced
    twin, which no plan launches, apart), from ptxas's reports."""
    found, name, spill = {}, None, ""
    for line in "\n".join(reports.get(s, "") for s in (
            "lstm_scan_bwd_wide", "gru_scan_bwd_wide")).splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            w = re.search(r"lstm_bwd_wide_kernelILi(\d)ELi(\d)E", line)
            g = re.search(r"gru_bwd_wide_kernelILi(\d+)ELi(\d+)ELb(\d)E",
                          line)
            if w:
                name = f"wide D {w.group(1)}x{w.group(2)}"
            elif g:
                name = (f"{'traced' if g.group(3) == '1' else 'wide'} G "
                        f"U={g.group(1)} R={g.group(2)}")
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _wide_bwd_identities(dev, L, gen):
    """At each of WIDE_BWD_SHAPES, forward and reverse: kernel D's wide
    cluster (wide_backwards()) bit for bit against the resident cluster
    (resident_backwards()) and the single block, and within the dgates
    limits of its plain version; each wide run counted. Returns the
    largest max and mean error against the plain version."""
    worst = [0.0, 0.0]
    for h, t_len, rows in WIDE_BWD_SHAPES:
        w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        gout = torch.randn(t_len, rows, h, generator=gen,
                           device=dev).to(torch.bfloat16)
        plan = L.card_bwd_wide_plan(dev, h, rows)
        block = _block_bwd_plan(L, dev, h, rows)
        for reverse in (False, True):
            tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
            h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh, reverse)
            ops = (gates, h_seq, c_seq, gout, w_hh, reverse)
            with L.wide_backwards():
                wide = _counted(L, WIDE_BWD_ENTRY,
                                lambda: L.lstm_scan_bwd_tm(*ops))
            with L.resident_backwards():
                resident = L.lstm_scan_bwd_tm(*ops)
            single = L.lstm_scan_bwd_planned_tm(*ops[:5], block, reverse)
            plain = L.lstm_scan_bwd_reference_tm(*ops)
            torch.cuda.synchronize()
            check(torch.equal(wide, resident) and torch.equal(wide, single),
                  f"{WIDE_BWD_ENTRY} == the resident cluster and the single "
                  f"block bitwise ({tag})")
            err = (wide.float() - plain.float()).abs()
            peak = plain.float().abs().max().item()
            mx, mean = err.max().item() / peak, err.mean().item() / peak
            check(torch.isfinite(wide.float()).all().item()
                  and mx < BWD_MAX_REL and mean < BWD_MEAN_REL,
                  f"{WIDE_BWD_ENTRY} vs plain within {BWD_MAX_REL}/"
                  f"{BWD_MEAN_REL} of the peak ({tag}: {mx:.3e}/{mean:.3e})")
            worst = [max(worst[0], err.max().item()),
                     max(worst[1], err.mean().item())]
            del h_seq, c_seq, wide, resident, single, plain, err
        log(f"{WIDE_BWD_ENTRY} == the resident cluster and the single block "
            f"bitwise at H={h} T={t_len} rows={rows} (forward and reverse); "
            f"wide plan {_describe_bwd(plan)}; route "
            f"{L.card_bwd_scan_plan(dev, h, rows).design}")
        del gates, gout
        torch.cuda.empty_cache()
    return worst


def _wide_bwd_times(dev, L, gen, card, registers):
    """Kernel D at the training shape (H=HIDDEN, T=TRAIN_T, TRAIN_ROWS):
    the wide cluster timed beside the resident cluster in turns (wide,
    resident, resident, wide), with the plain version, cuDNN's backward,
    the bound, the plan, its waves and modelled step, the route's design
    there, the instances' registers and the card."""
    h, t_len, rows = HIDDEN, TRAIN_T, TRAIN_ROWS
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    ops = (gates, h_seq, c_seq, gout, w_hh)
    plan = L.card_bwd_wide_plan(dev, h, rows)
    with L.resident_backwards():
        res_plan = L.card_bwd_scan_plan(dev, h, rows)
    rounds = [cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(*ops, p), iters=3)
              for p in (plan, res_plan, res_plan, plan)]
    ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
    plain = cuda_ms(lambda: L.lstm_scan_bwd_reference_tm(*ops), iters=2)
    lib_fwd, lib_both = library_lstm_train_ms(gates, w_hh, gout)
    b_ms, by = bound(t_len, rows, h, streams=11, products=2)
    route = L.card_bwd_scan_plan(dev, h, rows).design
    log(f"{WIDE_BWD_ENTRY} at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
        f"{1e3 * ms / t_len / plan.waves:.2f} us a step a wave (modelled "
        f"{plan.step_us:.2f}); resident cluster {ms_res:.3f} ms "
        f"({res_plan.waves} waves of {1e3 * ms_res / t_len / res_plan.waves:.2f}"
        f" us); rounds {' '.join(f'{r:.3f}' for r in rounds)}; bound "
        f"{b_ms:.4f} ms by {by}; plain {plain:.3f} ms; cuDNN LSTM backward "
        f"{lib_both - lib_fwd:.3f} ms; plan {_describe_bwd(plan)}; route "
        f"{route}; on {card}")
    log(f"{WIDE_BWD_ENTRY} instances: " + (", ".join(
        f"{k} {n}" for k, n in sorted(registers.items())
        if k.startswith("wide D")) or "not rebuilt in this run"))
    del ops, gates, gout, h_seq, c_seq
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                library_ms=lib_both - lib_fwd, resident_ms=ms_res,
                us_a_step=1e3 * ms / t_len / plan.waves, design=route,
                plan=dataclasses.asdict(plan))


def _steps_in_turns(dev, path, witness, n, what):
    """`path`'s bf16 training step (its EnhanceTrainConfig, TRAIN_BATCH x
    TRAIN_SAMPLES) on the route beside `witness()`, a context manager that
    forces the design the route replaced: one warm step of each design, n
    steps of each in turns (route, witness, witness, route), then one step
    of each for its peak memory and a profile of one more. Every step's
    launches are exactly its design's (routed_step of path.per_step, named
    under witness() for the witness). Returns {"route": ..., "witness":
    ...}, each with the step's launches (per_step), the launches of all
    its counted steps (launched), the timed steps (times, ms) and their
    median, the peak memory (GiB) and the profile (_profile's wall, busy
    and rows)."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import EnhanceTrainer
    trainer = EnhanceTrainer(path.train_config("bfloat16"), seed=SEED,
                             pretrained_state_dict=path.sd, device=dev)
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    designs = {"route": contextlib.nullcontext, "witness": witness}
    out = {}
    for part, design in designs.items():
        with design():
            out[part] = dict(per_step=routed_step(path.per_step), launched={},
                             times=[])

    def steps(k, part):
        times = []
        for _ in range(k):
            L.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_epoch([(noisy, clean)])   # ends in a fetch
            times.append((time.perf_counter() - t0) * 1e3)
            got = {key: v for key, v in L.launch_counts.items() if v}
            check(np.isfinite(loss), f"finite training loss on {what}")
            check(got == out[part]["per_step"], f"{what}'s training step "
                  f"({part}) launched {out[part]['per_step']} and nothing "
                  f"else (got {got})")
            for key, v in got.items():
                out[part]["launched"][key] = (
                    out[part]["launched"].get(key, 0) + v)
        return times

    for part in designs:                # warm: each design's shapes
        with designs[part]():
            steps(1, part)
    for part in ("route", "witness", "witness", "route"):
        with designs[part]():
            out[part]["times"] += steps(n, part)
    for part, r in out.items():
        r["median_ms"] = statistics.median(r["times"])
        with designs[part]():
            torch.cuda.reset_peak_memory_stats(dev)
            steps(1, part)
            r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            r["profile"] = _profile(
                lambda: trainer.train_epoch([(noisy, clean)]),
                f"{path.name} training step ({part}: {r['per_step']})")
    del trainer
    torch.cuda.empty_cache()
    return out


def _times_line(times):
    return " ".join(f"{x:.1f}" for x in times)


def _wide_bwd_path(dev, plus):
    """FullSubNet+'s bf16 training step (EnhanceTrainConfig, 18 x 3.072 s,
    2304 sub-band rows) on the route, with exact launches (2 of kernel D's
    routed entry a step), its median beside the resident cluster's in turns
    (WIDE_BWD_STEPS steps each: route, resident, resident, route), its peak
    memory and a profile of one step (_steps_in_turns under
    resident_backwards()). Returns the route's launches and the
    readings."""
    from generative_audio_torch.ops import lstm as L
    res = _steps_in_turns(dev, plus, L.resident_backwards, WIDE_BWD_STEPS,
                          "phase 27's path")
    route, resident = res["route"], res["witness"]
    wall, busy, rows = route["profile"]
    d_ms = sum(ms for key, ms, _ in rows if "bwd_wide" in key
               or "bwd_cluster" in key)
    out = dict(route_ms=route["median_ms"], resident_ms=resident["median_ms"],
               peak_gib=route["peak_gib"], profiled_ms=wall, busy_ms=busy,
               d_ms=d_ms)
    log(f"phase 27 (c) FullSubNet+ bf16 step, batch {TRAIN_BATCH} x "
        f"{TRAIN_SAMPLES / 16000:.3f} s: on the route (kernel D "
        f"{routed('lstm_scan_bwd', TRAIN_ROWS)}, {route['per_step']} a step) "
        f"median {out['route_ms']:.2f} ms of {_times_line(route['times'])}; "
        f"resident_backwards() {out['resident_ms']:.2f} ms of "
        f"{_times_line(resident['times'])}; peak memory {out['peak_gib']:.2f} "
        f"GiB; profiled {wall:.2f} ms, busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), kernel D {d_ms:.2f} ms; on "
        f"{card_line()}")
    return route["launched"], out


def phase_wide_backward(dev, registers):
    """Phase 27: kernel D as a wide cluster. (a) Bit for bit against the
    resident cluster and the single block at 2304, a ragged 2295 and 1024
    rows x T=195 and H=512 x 18 x 195 (forward and reverse), within the
    dgates limits of the plain version, and every wide plan of a spread ==
    the single block at small ragged shapes (scripts/perf_bwd_scan.py
    check_wide); (b) timed at 2304 x 195 beside the resident cluster, the
    plain version, cuDNN's backward and the bound, with the plan, waves,
    registers and the card; (c) the path: FullSubNet+'s bf16 training step
    on the route with exact launches, its median beside the resident
    cluster's, peak memory and a profile. Returns the entry's numbers and
    its launches on (c)."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(SEED + 270)
    check(PB.check_wide(dev, card, ("lstm",)) == 0,
          "every wide plan of the spread == the single block bitwise "
          "(scripts/perf_bwd_scan.py check_wide)")
    worst = _wide_bwd_identities(dev, L, gen)
    numbers = _wide_bwd_times(dev, L, gen, card, registers)
    numbers["max_abs_err"], numbers["mean_abs_err"] = worst
    plus, _, _ = model_paths()
    launches, numbers["path"] = _wide_bwd_path(dev, plus)
    log(f"launches on phase 27's path: {launches}; phase 27 "
        f"{time.perf_counter() - t0:.1f} s")
    routed_d = routed("lstm_scan_bwd", TRAIN_ROWS)
    check(launches.get(routed_d, 0) == 2 * (2 * WIDE_BWD_STEPS + 2),
          f"{routed_d} launched 2 a step on phase 27's path")
    return {WIDE_BWD_ENTRY: numbers}, {WIDE_BWD_ENTRY: launches.get(
        WIDE_BWD_ENTRY, 0)}


# Phase 29: kernel C as a wide cluster (csrc/lstm_scan_wide.cu
# lstm_scan_fwd_train_wide: kernel A's wide cluster, products on wgmma, that
# also stores the bf16 c sequence from the registers that hold c), the route
# of lstm_scan_train_tm wherever a resident cluster holds H and the wide
# cluster's modelled waves x step beat the resident cluster's: at the
# training batch (2304 rows) one wave of 160 rows a cluster where the
# resident cluster needs five of 32.
WIDE_C_ENTRY = "lstm_scan_fwd_train_wide"
# (H, T, rows) of the identities: the sub-band training batch and its
# ragged count, the NPPC head's 1024 rows, the full band's training shape.
WIDE_C_SHAPES = ((HIDDEN, TRAIN_T, TRAIN_ROWS),
                 (HIDDEN, TRAIN_T, TRAIN_RAGGED_ROWS),
                 (HIDDEN, TRAIN_T, 1024), (FB_HIDDEN, TRAIN_T, TRAIN_BATCH))
WIDE_C_STEPS = 4             # (c)'s timed steps of each design, in turns


def _wide_c_identities(dev, L, gen):
    """At each of WIDE_C_SHAPES, forward and reverse: kernel C's wide
    cluster (wide_forwards()) bit for bit against the resident cluster
    (resident_forwards(): h_seq and c_seq), its h_seq against the wide
    kernel A's bf16 h, two runs of one plan against each other, and both
    sequences within phase 3's limits of the plain version; each wide run
    counted. Returns the largest max and mean error against plain (c_seq's,
    the larger)."""
    worst = [0.0, 0.0]
    for h, t_len, rows in WIDE_C_SHAPES:
        w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        plan = L.card_wide_plan(dev, h, rows)
        for reverse in (False, True):
            tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
            with L.wide_forwards():
                wide = _counted(L, WIDE_C_ENTRY, lambda: L.lstm_scan_train_tm(
                    gates, w_hh, reverse))
                again = _counted(L, WIDE_C_ENTRY, lambda: (
                    L.lstm_scan_train_tm(gates, w_hh, reverse)))
                with torch.no_grad():
                    h_a = _counted(L, WIDE_ENTRIES[0], lambda: (
                        L.lstm_scan_tm(gates, w_hh, reverse)))
            with L.resident_forwards():
                resident = _counted(L, "lstm_scan_fwd_train", lambda: (
                    L.lstm_scan_train_tm(gates, w_hh, reverse)))
            plain = L.lstm_scan_train_reference_tm(gates, w_hh, reverse)
            torch.cuda.synchronize()
            diff = max((x.float() - y.float()).abs().max().item()
                       for x, y in zip(wide, resident))
            check(all(torch.equal(x, y) for x, y in zip(wide, resident)),
                  f"{WIDE_C_ENTRY} == lstm_scan_fwd_train bitwise: h_seq "
                  f"and c_seq ({tag}; worst |difference| {diff:.3e})")
            check(torch.equal(wide[0], h_a), f"{WIDE_C_ENTRY} h == "
                  f"{WIDE_ENTRIES[0]} h bitwise ({tag})")
            check(all(torch.equal(x, y) for x, y in zip(wide, again)),
                  f"two runs of {WIDE_C_ENTRY} under one plan bitwise ({tag})")
            err_h, err_c = ((x.float() - y.float()).abs()
                            for x, y in zip(wide, plain))
            # phase 3's limits: c is O(1) and rounded to bf16 on both sides
            check(all(torch.isfinite(x.float()).all().item() for x in wide)
                  and err_c.max().item() < 8 * KERNEL_MAX_ABS
                  and err_c.mean().item() < 8 * KERNEL_MEAN_ABS
                  and err_h.max().item() < 8 * KERNEL_MAX_ABS,
                  f"{WIDE_C_ENTRY} vs plain within {8 * KERNEL_MAX_ABS}/"
                  f"{8 * KERNEL_MEAN_ABS} ({tag}: c {err_c.max().item():.3e}/"
                  f"{err_c.mean().item():.3e}, h {err_h.max().item():.3e})")
            worst = [max(worst[0], err_c.max().item(), err_h.max().item()),
                     max(worst[1], err_c.mean().item(), err_h.mean().item())]
            del wide, again, h_a, resident, plain, err_h, err_c
        log(f"{WIDE_C_ENTRY} == the resident cluster bitwise (h_seq, c_seq), "
            f"its h == {WIDE_ENTRIES[0]}'s, two runs equal, at H={h} "
            f"T={t_len} rows={rows} (forward and reverse); wide plan "
            f"{_wide_plan_line(plan)}; route "
            f"{L._forward_route(h, rows, dev, (0, 0, 1))[1] or 'resident'}")
        del gates
        torch.cuda.empty_cache()
    return worst


def _wide_c_times(dev, L, gen, rows, card):
    """Kernel C at (H=HIDDEN, T=TRAIN_T, rows): the wide cluster timed
    beside the resident cluster in turns (wide, resident, resident, wide),
    with the plain version, cuDNN's training forward, the bound, both plans
    with their waves and modelled steps, and the route's pick."""
    h, t_len = HIDDEN, TRAIN_T
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)

    def wide():
        with L.wide_forwards():
            return L.lstm_scan_train_tm(gates, w_hh)

    def resident():
        with L.resident_forwards():
            return L.lstm_scan_train_tm(gates, w_hh)

    rounds = [cuda_ms(wide, iters=3), cuda_ms(resident, iters=3),
              cuda_ms(resident, iters=3), cuda_ms(wide, iters=3)]
    ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
    plain = cuda_ms(lambda: L.lstm_scan_train_reference_tm(gates, w_hh),
                    iters=2)
    library = library_lstm_train_ms(gates, w_hh)[0]
    b_ms, by = bound(t_len, rows, h, streams=6)   # gates in, h and c out
    plan = L.card_wide_plan(dev, h, rows)
    res_plan = L.card_scan_plan(dev, h, rows, train=True)
    res_us = L.scan_step_us(h, res_plan.cluster, res_plan.rows)
    route = L._forward_route(h, rows, dev, (0, 0, 1))[1]
    log(f"{WIDE_C_ENTRY} at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
        f"{1e3 * ms / t_len / plan.waves:.3f} us a step a wave (modelled "
        f"{plan.step_us:.3f}: {plan.waves * plan.step_us * t_len / 1e3:.3f} "
        f"ms); resident cluster {ms_res:.3f} ms, "
        f"{1e3 * ms_res / t_len / res_plan.waves:.3f} us a step a wave "
        f"(modelled {res_us:.3f}, {res_plan.waves} waves: "
        f"{res_plan.waves * res_us * t_len / 1e3:.3f} ms); rounds "
        f"{' '.join(f'{r:.3f}' for r in rounds)}; bound {b_ms:.4f} ms by "
        f"{by}; plain {plain:.3f} ms; cuDNN LSTM forward, training mode, "
        f"{library:.3f} ms; plan {_wide_plan_line(plan)}; route "
        f"{'wide' if route == '_wide' else 'resident'}; on {card}")
    del gates
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                library_ms=library, resident_ms=ms_res,
                us_a_step=1e3 * ms / t_len / plan.waves,
                design="wide" if route == "_wide" else "resident",
                plan=dataclasses.asdict(plan))


def _wide_c_path(dev, plus):
    """FullSubNet+'s bf16 training step (EnhanceTrainConfig, 18 x 3.072 s,
    2304 sub-band rows) on the route, with exact launches (2 of kernel C's
    routed entry and 2 of kernel D's a step), its median beside
    resident_forwards()' (kernel C's resident cluster, launches as exact)
    in turns (WIDE_C_STEPS steps each: route, resident, resident, route)
    and a profile of one step of each (_steps_in_turns). Returns the
    launches of both designs' steps and the readings."""
    from generative_audio_torch.ops import lstm as L
    res = _steps_in_turns(dev, plus, L.resident_forwards, WIDE_C_STEPS,
                          "phase 29's path")
    out = {"route_ms": res["route"]["median_ms"],
           "resident_ms": res["witness"]["median_ms"]}
    launched = {}
    for part, r in res.items():
        wall, busy, rows = r["profile"]
        c_ms = sum(ms for key, ms, _ in rows if "lstm_wide_kernel" in key
                   or "lstm_cluster_kernel" in key)
        d_ms = sum(ms for key, ms, _ in rows if "bwd_wide" in key
                   or "bwd_cluster" in key)
        out["route" if part == "route" else "resident"] = dict(
            profiled_ms=wall, busy_ms=busy, c_ms=c_ms, d_ms=d_ms,
            peak_gib=r["peak_gib"])
        for k, n in r["launched"].items():
            launched[k] = launched.get(k, 0) + n
    log(f"phase 29 (c) FullSubNet+ bf16 step, batch {TRAIN_BATCH} x "
        f"{TRAIN_SAMPLES / 16000:.3f} s: on the route "
        f"({res['route']['per_step']} a step) median {out['route_ms']:.2f} ms "
        f"of {_times_line(res['route']['times'])}; resident_forwards() "
        f"({res['witness']['per_step']}) {out['resident_ms']:.2f} ms of "
        f"{_times_line(res['witness']['times'])}; profiled: " + "; ".join(
            f"{part} {r['profiled_ms']:.2f} ms, busy {r['busy_ms']:.2f} "
            f"({100 * r['busy_ms'] / r['profiled_ms']:.1f}%), kernel C "
            f"{r['c_ms']:.2f} ms, kernel D {r['d_ms']:.2f} ms "
            f"({100 * (r['c_ms'] + r['d_ms']) / r['busy_ms']:.1f}% of busy), "
            f"peak memory {r['peak_gib']:.2f} GiB"
            for part, r in (("route", out["route"]),
                            ("resident", out["resident"])))
        + f"; on {card_line()}")
    return launched, out


def phase_wide_train(dev, registers):
    """Phase 29: kernel C as a wide cluster. (a) Every instance's registers
    without a spill (kernel C runs kernel A's instances); bit for bit
    against the resident cluster (h_seq and c_seq) at 2304, a ragged 2295
    and 1024 rows x T=195 and H=512 x 18 x 195, forward and reverse, its h
    against the wide kernel A's, two runs against each other, within phase
    3's limits of the plain version; (b) timed at 2304 and 1024 rows beside
    the resident cluster (in turns), the plain version, cuDNN's training
    forward and the bound, with both plans and the route's pick; (c) the
    path: FullSubNet+'s bf16 training step on the route beside
    resident_forwards() in turns, exact launches, medians and a profile of
    each. Returns the entry's numbers and the launches of (c) (the route's
    and, for the resident entry, resident_forwards()' steps)."""
    from generative_audio_torch.ops import lstm as L
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    wide = {k: v for k, v in registers.items() if k.startswith("wide ")
            and k.endswith(" rows")}
    log(f"kernel C's wide instances (kernel A's): "
        f"{_registers_line(wide, 'w')}")
    check(all(v.endswith(" 0/0 B spilled") for v in wide.values()),
          "no wide instance of kernel C spills")
    gen = torch.Generator(device=dev).manual_seed(SEED + 290)
    worst = _wide_c_identities(dev, L, gen)
    numbers = _wide_c_times(dev, L, gen, TRAIN_ROWS, card)
    numbers["nppc_head"] = _wide_c_times(dev, L, gen, 1024, card)
    numbers["max_abs_err"], numbers["mean_abs_err"] = worst
    plus, _, _ = model_paths()
    launches, numbers["path"] = _wide_c_path(dev, plus)
    log(f"launches on phase 29's path: {launches}; phase 29 "
        f"{time.perf_counter() - t0:.1f} s")
    routed_c = routed("lstm_scan_fwd_train", TRAIN_ROWS)
    check(routed_c == WIDE_C_ENTRY
          and launches.get(routed_c, 0) == 2 * (2 * WIDE_C_STEPS + 2),
          f"{WIDE_C_ENTRY} is the route at {TRAIN_ROWS} rows and launched 2 "
          f"a step on phase 29's path")
    return {WIDE_C_ENTRY: numbers}, {
        k: launches.get(k, 0) for k in C_ENTRIES}


# Phase 28: the GRU backward (TPU row 7) for Hopper: the scan as a wide
# cluster (csrc/gru_scan_bwd_wide.cu) and the dW_hh contraction with one
# wgmma group in flight and slices by a model of the card (csrc/
# gru_scan_bwd.cu, ops/gru.py plan_dwhh).
GRU_WIDE_ENTRY = "gru_scan_bwd_wide"
# (H, T, rows) of the identities: v1's sub-band training batch and its
# ragged count, a band rank's half of it, 1024 rows, the full band's
# training shape.
GRU_WIDE_SHAPES = ((HIDDEN, TRAIN_T, TRAIN_ROWS),
                   (HIDDEN, TRAIN_T, TRAIN_RAGGED_ROWS),
                   (HIDDEN, TRAIN_T, TRAIN_ROWS // 2),
                   (HIDDEN, TRAIN_T, 1024), (FB_HIDDEN, TRAIN_T, TRAIN_BATCH))
GRU_WIDE_STEPS = 8           # (d)'s timed steps of each design, in turns
# The contraction's new design against its first and torch.mm: its two
# runs are bit for bit; against the plain version (a float32 matmul) the
# kernels' limit DWHH_ALONE_REL; against the first design and torch.mm
# (the same fp32 sums in other orders: at N = 446 976 unit-normal rows an
# fp32 rounding of about sqrt(N) x 2^-24 of the norm, 4.1-4.5e-5 measured)
# 2e-4 of the norm.
DWHH_ORDER_REL = 2e-4


def _gru_wide_identities(dev, G, gen):
    """At each of GRU_WIDE_SHAPES, forward and reverse: the wide cluster
    (wide_backwards()) bit for bit against the resident cluster
    (resident_backwards()) and the single block (dgx, dhn, every db_hh
    partial), and within row 7's limits of its plain version (dgx of the
    peak, dW_hh and db_hh of the norm); each wide run counted. Returns the
    largest max and mean dgx error against the plain version."""
    from generative_audio_torch.ops import lstm as L
    worst = [0.0, 0.0]
    for h, t_len, rows in GRU_WIDE_SHAPES:
        w_hh = _uniform(gen, dev, (h, 3 * h), h ** -0.5)
        b_hh = _uniform(gen, dev, (3 * h,), h ** -0.5)
        gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        gout = torch.randn(t_len, rows, h, generator=gen,
                           device=dev).to(torch.bfloat16)
        plan = G.card_bwd_wide_plan(dev, h, rows)
        block = _block_bwd_plan(G, dev, h, rows)
        for reverse in (False, True):
            tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
            with torch.no_grad():
                h_seq = G.gru_scan_tm(gates, w_hh, b_hh, reverse)
            ops = (gates, h_seq, gout, w_hh, b_hh)
            with L.wide_backwards():
                wide = _counted(L, GRU_WIDE_ENTRY,
                                lambda: G.gru_scan_bwd_streams_planned_tm(
                                    *ops, G.card_bwd_scan_plan(dev, h, rows),
                                    reverse))
            with L.resident_backwards():
                resident = G.gru_scan_bwd_streams_planned_tm(
                    *ops, G.card_bwd_scan_plan(dev, h, rows), reverse)
            single = G.gru_scan_bwd_streams_planned_tm(*ops, block, reverse)
            p_dgx, p_dhn, p_db = G.gru_scan_bwd_streams_reference_tm(
                *ops, reverse)
            dw = G.gru_dwhh(*G.shifted_rows(h_seq, wide[0], wide[1], reverse))
            p_dw = G.gru_dwhh_reference(*G.shifted_rows(h_seq, p_dgx, p_dhn,
                                                        reverse))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) and torch.equal(a, c)
                      for a, b, c in zip(wide, resident, single)),
                  f"{GRU_WIDE_ENTRY} == the resident cluster and the single "
                  f"block bitwise (dgx, dhn, {wide[2].shape[0]} db_hh "
                  f"partials; {tag})")
            err = (wide[0].float() - p_dgx.float()).abs()
            peak = p_dgx.float().abs().max().item()
            mx, mean = err.max().item() / peak, err.mean().item() / peak
            rel_w = _rel_norm(dw, p_dw)
            rel_b = _rel_norm(wide[2].sum(dim=0), p_db)
            check(torch.isfinite(wide[0].float()).all().item()
                  and mx < BWD_MAX_REL and mean < BWD_MEAN_REL
                  and rel_w < BWD_DW_REL and rel_b < BWD_DW_REL,
                  f"{GRU_WIDE_ENTRY} vs plain within {BWD_MAX_REL}/"
                  f"{BWD_MEAN_REL} of the peak, dW_hh and db_hh within "
                  f"{BWD_DW_REL} of the norm ({tag}: {mx:.3e}/{mean:.3e}, "
                  f"{rel_w:.3e}, {rel_b:.3e})")
            worst = [max(worst[0], err.max().item()),
                     max(worst[1], err.mean().item())]
            del h_seq, wide, resident, single, p_dgx, p_dhn, err
        log(f"{GRU_WIDE_ENTRY} == the resident cluster and the single block "
            f"bitwise at H={h} T={t_len} rows={rows} (forward and reverse; "
            f"dgx, dhn, db_hh partials); wide plan {_describe_bwd(plan)}; "
            f"route {G.card_bwd_scan_plan(dev, h, rows).design}")
        del gates, gout
        torch.cuda.empty_cache()
    return worst


def _gru_wide_times(dev, G, gen, card, registers):
    """The scan at v1's sub-band training shape (H=HIDDEN, T=TRAIN_T,
    TRAIN_ROWS): the wide cluster beside the resident cluster in turns
    (wide, resident, resident, wide), with the plain version, cuDNN's GRU
    backward, the bound, the plan, its waves and modelled step, the
    route's design there, the instances' registers and the card."""
    from generative_audio_torch.ops import lstm as L
    h, t_len, rows = HIDDEN, TRAIN_T, TRAIN_ROWS
    w_hh = _uniform(gen, dev, (h, 3 * h), h ** -0.5)
    b_hh = _uniform(gen, dev, (3 * h,), h ** -0.5)
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    with torch.no_grad():
        h_seq = G.gru_scan_tm(gates, w_hh, b_hh)
    ops = (gates, h_seq, gout, w_hh, b_hh)
    plan = G.card_bwd_wide_plan(dev, h, rows)
    with L.resident_backwards():
        res_plan = G.card_bwd_scan_plan(dev, h, rows)
    rounds = [cuda_ms(lambda: G.gru_scan_bwd_streams_planned_tm(*ops, p),
                      iters=3) for p in (plan, res_plan, res_plan, plan)]
    ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
    plain = cuda_ms(lambda: G.gru_scan_bwd_streams_reference_tm(*ops),
                    iters=2)
    lib_fwd, lib_both = library_gru_train_ms(gates, w_hh, b_hh, gout)
    b_ms, by = bound(t_len, rows, h, streams=9, products=2, gates=3,
                     extra_bytes=2 * 3 * h * 4)
    route = G.card_bwd_scan_plan(dev, h, rows).design
    log(f"{GRU_WIDE_ENTRY} at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
        f"{1e3 * ms / t_len / plan.waves:.2f} us a step a wave (modelled "
        f"{plan.step_us:.2f}); resident cluster {ms_res:.3f} ms "
        f"({res_plan.waves} waves of "
        f"{1e3 * ms_res / t_len / res_plan.waves:.2f} us); rounds "
        f"{' '.join(f'{r:.3f}' for r in rounds)}; bound "
        f"{b_ms:.4f} ms by {by}; plain {plain:.3f} ms; cuDNN GRU backward "
        f"{lib_both - lib_fwd:.3f} ms (dW_hh, db_hh included); plan "
        f"{_describe_bwd(plan)}; route {route}; on {card}")
    log(f"{GRU_WIDE_ENTRY} instances: " + (", ".join(
        f"{k} {n}" for k, n in sorted(registers.items())
        if k.startswith("wide G")) or "not rebuilt in this run"))
    del ops, gates, gout, h_seq
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                library_ms=lib_both - lib_fwd, resident_ms=ms_res,
                us_a_step=1e3 * ms / t_len / plan.waves, design=route,
                plan=dataclasses.asdict(plan))


def _gru_dwhh_times(dev, card):
    """The contraction at N = 194 x TRAIN_ROWS (H=HIDDEN) and 194 x
    TRAIN_BATCH (H=FB_HIDDEN) by scripts/perf_bwd_scan.py dwhh_rounds:
    plan_dwhh's plan, the first design's (plan_dwhh_first) and one
    fp32-output torch.mm of the same product in turns, with the bound; the
    new one twice, bit for bit, and within DWHH_ALONE_REL of the plain
    version and DWHH_ORDER_REL of the first design and torch.mm. Returns
    the numbers of both shapes."""
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    out = {}
    for key, h, n in (("sub_band", HIDDEN, (TRAIN_T - 1) * TRAIN_ROWS),
                      ("full_band", FB_HIDDEN, (TRAIN_T - 1) * TRAIN_BATCH)):
        r = PB.dwhh_rounds(dev, h, n, seed=SEED + 280 + h)
        new, first, best, rel = r["new"], r["first"], r["best"], r["rel"]
        b_ms, by = _larger(n * 4 * h * 2 + h * 3 * h * 4, 2 * n * h * 3 * h)
        rounds = " ".join(f"{o} {t:.4f}" for o, t in zip(r["order"],
                                                         r["times"]))
        log(f"GRU dW_hh contraction at H={h} over N={n}: new {best['new']:.4f}"
            f" ms ({new.tiles} tiles, {new.slices} slices, narrow "
            f"{new.narrow_tiles} x {new.narrow_slices}, one wgmma group in "
            f"flight; modelled {new.us / 1e3:.4f}), first design "
            f"{best['first']:.4f} ms ({first.slices} slices, every group "
            f"waited for), torch.mm fp32 out {best['mm']:.4f} ms; rounds "
            f"{rounds}; device time (profiler, the sum included) new "
            f"{r['device_us']['new']:.2f} us, first "
            f"{r['device_us']['first']:.2f}, torch.mm "
            f"{r['device_us']['mm']:.2f}; bound {b_ms:.4f} ms by {by}; plain "
            f"{r['plain_ms']:.3f} ms; two runs bit for bit: {r['repeats']}; "
            f"|new - x| / |x|: plain {rel['plain']:.3e}, first "
            f"{rel['first']:.3e}, torch.mm {rel['mm']:.3e}; on {card}")
        check(r["repeats"], f"the contraction repeats bit for bit (H={h}, "
              f"N={n})")
        check(rel["plain"] < DWHH_ALONE_REL and rel["first"] < DWHH_ORDER_REL
              and rel["mm"] < DWHH_ORDER_REL,
              f"the contraction within {DWHH_ALONE_REL} of plain and "
              f"{DWHH_ORDER_REL} of the first design and torch.mm (H={h}, "
              f"N={n})")
        out[key] = dict(ms=best["new"], first_ms=best["first"],
                        library_ms=best["mm"], bound_ms=b_ms, bound_by=by,
                        plain_ms=r["plain_ms"], rel=rel,
                        device_us=r["device_us"],
                        plan=dataclasses.asdict(new))
        torch.cuda.empty_cache()
    return out


def _gru_wide_path(dev, v1_gru):
    """FullSubNet v1-GRU's bf16 training step (EnhanceTrainConfig, 18 x
    3.072 s: the sub-band GRU over 2304 rows, the full band over 18) on the
    new routes, with exact launches (4 forwards, 4 backward scans named by
    the route at their rows, 4 contractions a step), its median beside
    resident_backwards() with the first design's contraction in turns
    (GRU_WIDE_STEPS // 2 steps each: route, first, first, route), its peak
    memory and a profile of one step (_steps_in_turns). Returns the route's
    launches and the readings."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L

    @contextlib.contextmanager
    def first_design():
        with L.resident_backwards(), mock.patch.object(
                G, "plan_dwhh",
                lambda n, h, sms=None: G.plan_dwhh_first(n, h)):
            yield

    res = _steps_in_turns(dev, v1_gru, first_design, GRU_WIDE_STEPS // 2,
                          "phase 28's path")
    route, first = res["route"], res["witness"]
    wall, busy, rows = route["profile"]
    scan_ms = sum(ms for key, ms, _ in rows if "gru_bwd" in key)
    dwhh_ms = sum(ms for key, ms, _ in rows if "dwhh" in key)
    out = dict(route_ms=route["median_ms"], first_ms=first["median_ms"],
               peak_gib=route["peak_gib"], profiled_ms=wall, busy_ms=busy,
               scan_ms=scan_ms, dwhh_ms=dwhh_ms)
    log(f"phase 28 (d) FullSubNet v1-GRU bf16 step, batch {TRAIN_BATCH} x "
        f"{TRAIN_SAMPLES / 16000:.3f} s: on the routes ({route['per_step']} a "
        f"step) median {out['route_ms']:.2f} ms of "
        f"{_times_line(route['times'])}; resident_backwards() with the first "
        f"contraction {out['first_ms']:.2f} ms of "
        f"{_times_line(first['times'])}; peak memory {out['peak_gib']:.2f} "
        f"GiB; profiled {wall:.2f} ms, busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), backward scans {scan_ms:.2f} ms, "
        f"contractions {dwhh_ms:.2f} ms; on {card_line()}")
    return route["launched"], out


def phase_gru_wide_backward(dev, registers):
    """Phase 28: the GRU backward (TPU row 7). (a) The wide scan bit for bit
    against the resident cluster and the single block (dgx, dhn, every db_hh
    partial) at 2304, a ragged 2295 and 1024 rows x T=195 and H=512 x 18 x
    195 (forward and reverse), within row 7's limits of the plain version,
    and every wide plan of a spread == the single block at small ragged
    shapes, T=1 among them (scripts/perf_bwd_scan.py check_wide); (b) timed
    at 2304 x 195 beside the resident cluster, the plain version, cuDNN's
    backward and the bound, with the plan, waves, registers and the card;
    (c) the contraction's new and first designs and torch.mm at N = 446 976
    (H=384) and 3492 (H=512) in turns, with the bound, twice bit for bit;
    (d) the path: FullSubNet v1-GRU's bf16 training step on the routes with
    exact launches, its median beside resident_backwards() with the first
    contraction, peak memory and a profile. Returns the entries' numbers
    and the wide entry's launches on (d)."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.scripts import perf_bwd_scan as PB
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    wide = {k: v for k, v in registers.items() if k.startswith("wide G")}
    log(f"{GRU_WIDE_ENTRY} instances (units, rows; wgmma): "
        f"{_registers_line(wide, 'w')}; its traced twin, which no plan "
        f"launches: " + ", ".join(f"{k} {v}" for k, v in registers.items()
                                  if k.startswith("traced G")))
    check(all(v.endswith(" 0/0 B spilled") for v in wide.values()),
          f"no instance of {GRU_WIDE_ENTRY} spills")
    gen = torch.Generator(device=dev).manual_seed(SEED + 280)
    check(PB.check_wide(dev, card, ("gru",)) == 0, "every GRU wide plan of "
          "the spread == the single block bitwise (scripts/perf_bwd_scan.py "
          "check_wide)")
    worst = _gru_wide_identities(dev, G, gen)
    numbers = _gru_wide_times(dev, G, gen, card, registers)
    numbers["max_abs_err"], numbers["mean_abs_err"] = worst
    contraction = _gru_dwhh_times(dev, card)
    _, v1_gru, _ = model_paths()
    launches, numbers["path"] = _gru_wide_path(dev, v1_gru)
    log(f"launches on phase 28's path: {launches}; phase 28 "
        f"{time.perf_counter() - t0:.1f} s")
    steps = GRU_WIDE_STEPS + 2
    expected = {k: n * steps for k, n in routed_step(v1_gru.per_step).items()}
    check(launches == expected, f"phase 28's path launched {expected} "
          f"(got {launches})")
    return ({GRU_WIDE_ENTRY: numbers,
             "gru_scan_bwd_dwhh": {"contraction": contraction}},
            {GRU_WIDE_ENTRY: launches.get(GRU_WIDE_ENTRY, 0)})


# Phase 30: the GRU forward and carry (TPU rows 6 and 8) as wide clusters
# (csrc/gru_scan_wide.cu): kernel A's wide design with the GRU cell.
GRU_FWD_WIDE = ("gru_scan_fwd_wide", "gru_scan_fwd_carry_wide")
# (H, T, rows) of the identities: v1's sub-band serving batch, a ragged
# count and one 10 s request; its sub-band training batch, a ragged count
# and 1024 rows; the full band's training and serving shapes.
GRU_FWD_WIDE_SHAPES = ((HIDDEN, T_FRAMES, ROWS),
                       (HIDDEN, T_FRAMES, RAGGED_ROWS),
                       (HIDDEN, T_FRAMES, ROWS // 8),
                       (HIDDEN, TRAIN_T, TRAIN_ROWS),
                       (HIDDEN, TRAIN_T, TRAIN_RAGGED_ROWS),
                       (HIDDEN, TRAIN_T, 1024),
                       (FB_HIDDEN, TRAIN_T, TRAIN_BATCH),
                       (FB_HIDDEN, T_FRAMES, FB_SERVE_ROWS))
GRU_FWD_WIDE_STEPS = 4       # (c)'s timed steps of each design, in turns


def _gru_wide_registers(reports):
    """{"gru wide 144 rows": "... registers, ... spilled", ...} for the
    instances gru_wide_kernel<N> of csrc/gru_scan_wide.cu (N rows a
    cluster; both entries, both output types), from ptxas's report (the
    registers a thread launches with; the consumers take more by
    setmaxnreg)."""
    found, name, spill = {}, None, ""
    for line in reports.get("gru_scan_wide", "").splitlines():
        if "Compiling entry function" in line:
            name, spill = None, ""
            w = re.search(r"gru_wide_kernelILi(\d+)E", line)
            if w:
                name = f"gru wide {int(w.group(1)):3d} rows"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if stores and name:
            spill = f"{stores.group(1)}/{stores.group(2)} B spilled"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            found[name], name = f"{used.group(1)} registers, {spill}", None
    return found


def _gru_chunked_carry(G, gates, w_hh, b_hh, h0, reverse, out_dtype):
    """The GRU carry over chunks of T_CHUNK steps, the state handed on
    (from the later chunk when reversed): (h sequence, h_T)."""
    t_len = gates.shape[0]
    out = torch.empty(t_len, gates.shape[1], w_hh.shape[0], dtype=out_dtype,
                      device=gates.device)
    hs = h0
    starts = list(range(0, t_len, T_CHUNK))
    for s in (starts[::-1] if reverse else starts):
        e = min(s + T_CHUNK, t_len)
        out[s:e], hs = G.gru_scan_carry_tm(gates[s:e], w_hh, b_hh, hs,
                                           reverse, out_dtype)
    return out, hs


def _gru_fwd_wide_identities(dev, G, gen):
    """At each of GRU_FWD_WIDE_SHAPES, forward and reverse, bf16 and fp32
    out: both wide entries (wide_forwards()) bit for bit against the
    resident cluster (resident_forwards(); the carry from a random state:
    h and h_T), the carry from zero in chunks of T_CHUNK against the
    unchunked forward and its final state, the forward twice against
    itself, and at fp32 out within the GRU forward's limits of the plain
    versions; each wide run counted. Returns each entry's largest max and
    mean error against plain."""
    from generative_audio_torch.ops import lstm as L
    worst = {name: [0.0, 0.0] for name in GRU_FWD_WIDE}
    for h, t_len, rows in GRU_FWD_WIDE_SHAPES:
        w_hh = _uniform(gen, dev, (h, 3 * h), h ** -0.5)
        b_hh = _uniform(gen, dev, (3 * h,), h ** -0.5)
        gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        h0 = _uniform(gen, dev, (rows, h), 1.0)
        zero = torch.zeros(rows, h, device=dev)
        n_chunks = -(-t_len // T_CHUNK)
        plan = G.card_gru_wide_plan(dev, h, rows)
        for reverse in (False, True):
            p_f = G.gru_scan_reference_tm(gates, w_hh, b_hh, reverse)
            p_c = G.gru_scan_carry_reference_tm(gates, w_hh, b_hh, h0,
                                                reverse)
            for out_dtype in (torch.bfloat16, torch.float32):
                tag = (f"H={h} T={t_len} rows={rows} reverse={reverse} "
                       f"{out_dtype}")
                with torch.no_grad():
                    with L.resident_forwards():
                        f_res = _counted(L, "gru_scan_fwd", lambda: (
                            G.gru_scan_tm(gates, w_hh, b_hh, reverse,
                                          out_dtype)))
                        c_res = G.gru_scan_carry_tm(gates, w_hh, b_hh, h0,
                                                    reverse, out_dtype)
                        c_zero = G.gru_scan_carry_tm(gates, w_hh, b_hh, zero,
                                                     reverse, out_dtype)
                    with L.wide_forwards():
                        f = _counted(L, GRU_FWD_WIDE[0], lambda: (
                            G.gru_scan_tm(gates, w_hh, b_hh, reverse,
                                          out_dtype)))
                        again = _counted(L, GRU_FWD_WIDE[0], lambda: (
                            G.gru_scan_tm(gates, w_hh, b_hh, reverse,
                                          out_dtype)))
                        c = _counted(L, GRU_FWD_WIDE[1], lambda: (
                            G.gru_scan_carry_tm(gates, w_hh, b_hh, h0,
                                                reverse, out_dtype)))
                        chunked = _counted(
                            L, GRU_FWD_WIDE[1], lambda: _gru_chunked_carry(
                                G, gates, w_hh, b_hh, zero, reverse,
                                out_dtype), n_chunks)
                diff = max((x.float() - y.float()).abs().max().item()
                           for x, y in zip((f, *c), (f_res, *c_res)))
                check(torch.equal(f, f_res), f"{GRU_FWD_WIDE[0]} == "
                      f"gru_scan_fwd bitwise ({tag}; worst |difference| of "
                      f"both entries {diff:.3e})")
                check(all(torch.equal(x, y) for x, y in zip(c, c_res)),
                      f"{GRU_FWD_WIDE[1]} == gru_scan_fwd_carry bitwise: h, "
                      f"h_T ({tag})")
                check(torch.equal(f, again), f"two runs of {GRU_FWD_WIDE[0]} "
                      f"under one plan bitwise ({tag})")
                check(torch.equal(chunked[0], f_res)
                      and torch.equal(chunked[1], c_zero[1]),
                      f"{GRU_FWD_WIDE[1]} in {n_chunks} chunks of {T_CHUNK} "
                      f"== unchunked bitwise, its state too ({tag})")
                for name, got, want in (((GRU_FWD_WIDE[0], (f,), (p_f,)),
                                         (GRU_FWD_WIDE[1], c, p_c))
                                        if out_dtype == torch.float32 else ()):
                    errs = [(x.float() - y.float()).abs()
                            for x, y in zip(got, want)]
                    mx = max(e.max().item() for e in errs)
                    mean = max(e.mean().item() for e in errs)
                    check(all(torch.isfinite(x).all().item() for x in got)
                          and mx < KERNEL_MAX_ABS and mean < GRU_FWD_MEAN_ABS,
                          f"{name} vs plain within {KERNEL_MAX_ABS}/"
                          f"{GRU_FWD_MEAN_ABS} ({tag}: {mx:.3e}/{mean:.3e})")
                    worst[name] = [max(worst[name][0], mx),
                                   max(worst[name][1], mean)]
                del f, again, c, chunked, f_res, c_res, c_zero
            del p_f, p_c
        log(f"GRU wide entries == the resident cluster bitwise at H={h} "
            f"T={t_len} rows={rows} (forward and reverse, bf16 and fp32 out, "
            f"the carry from a state and in {n_chunks} chunks of {T_CHUNK} "
            f"== unchunked, two runs equal); wide plan "
            f"{_wide_plan_line(plan)}; route "
            f"{G._forward_route(h, rows, dev)[1] or 'resident'}")
        del gates, h0, zero
        torch.cuda.empty_cache()
    return worst


def _gru_fwd_wide_times(dev, G, gen, h, t_len, rows, card, carry=True):
    """The GRU forward (and, with `carry`, the carry in one chunk) at (h,
    t_len, rows), bf16 out as the paths run them: the wide cluster timed
    beside the resident cluster in turns (wide, resident, resident, wide),
    with the plain version, cuDNN's nn.GRU, the bound, both plans with
    their waves and modelled steps, and the route's pick."""
    from generative_audio_torch.ops import lstm as L
    w_hh = _uniform(gen, dev, (h, 3 * h), h ** -0.5)
    b_hh = _uniform(gen, dev, (3 * h,), h ** -0.5)
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    h0 = _uniform(gen, dev, (rows, h), 1.0)
    library = library_gru_ms(gates, w_hh, b_hh)
    # gates in (3 streams of H), h out (1), W_hh, b_hh; the carry also
    # reads and writes the fp32 state once
    calls = {GRU_FWD_WIDE[0]: (
        lambda: G.gru_scan_tm(gates, w_hh, b_hh),
        lambda: G.gru_scan_reference_tm(gates, w_hh, b_hh),
        bound(t_len, rows, h, streams=4, gates=3, extra_bytes=3 * h * 4),
        (0, 0))}
    if carry:
        calls[GRU_FWD_WIDE[1]] = (
            lambda: G.gru_scan_carry_tm(gates, w_hh, b_hh, h0),
            lambda: G.gru_scan_carry_reference_tm(gates, w_hh, b_hh, h0),
            bound(t_len, rows, h, streams=4, gates=3,
                  extra_bytes=3 * h * 4 + 2 * rows * h * 4), (0, 1))
    out = {}
    for name, (timed, plain, (b_ms, by), instance) in calls.items():

        def wide():
            with L.wide_forwards():
                return timed()

        def resident():
            with L.resident_forwards():
                return timed()

        with torch.no_grad():
            rounds = [cuda_ms(wide, iters=3), cuda_ms(resident, iters=3),
                      cuda_ms(resident, iters=3), cuda_ms(wide, iters=3)]
            plain_ms = cuda_ms(plain, iters=2)
        ms, ms_res = min(rounds[0], rounds[3]), min(rounds[1:3])
        plan = G.card_gru_wide_plan(dev, h, rows)
        res_plan = G.card_scan_plan(dev, h, rows, carry=bool(instance[1]))
        res_us = G.scan_step_us(h, res_plan.cluster, res_plan.rows)
        route = G._forward_route(h, rows, dev, instance)[1]
        log(f"{name} at T={t_len} rows={rows} H={h}: {ms:.3f} ms, "
            f"{1e3 * ms / t_len / plan.waves:.3f} us a step a wave (modelled "
            f"{plan.step_us:.3f}, {plan.waves} waves: "
            f"{plan.waves * plan.step_us * t_len / 1e3:.3f} ms); resident "
            f"cluster {ms_res:.3f} ms, "
            f"{1e3 * ms_res / t_len / res_plan.waves:.3f} us a step a wave "
            f"(modelled {res_us:.3f}, {res_plan.waves} waves: "
            f"{res_plan.waves * res_us * t_len / 1e3:.3f} ms); rounds "
            f"{' '.join(f'{r:.3f}' for r in rounds)}; bound {b_ms:.4f} ms by "
            f"{by}; plain {plain_ms:.3f} ms; cuDNN GRU {library:.3f} ms; plan "
            f"{_wide_plan_line(plan)}; route "
            f"{'wide' if route == '_wide' else 'resident'}; on {card}")
        check((route == "_wide") == (ms < ms_res) or abs(ms - ms_res) < 0.02
              * ms_res, f"the route at H={h} x {rows} rows takes the faster "
              f"design ({name}: wide {ms:.3f} ms, resident {ms_res:.3f} ms, "
              f"route {route or 'resident'})")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=library, resident_ms=ms_res,
                         us_a_step=1e3 * ms / t_len / plan.waves,
                         resident_us_a_step=1e3 * ms_res / t_len
                         / res_plan.waves,
                         route="wide" if route == "_wide" else "resident",
                         plan=dataclasses.asdict(plan))
    del gates, h0
    torch.cuda.empty_cache()
    return out


def _gru_one_wave_at_2304(dev, G, gen, card):
    """At the training batch (2304 rows x T=195) the planner's wide plan
    against the one-wave plan of 160 rows a cluster (the most rows, W_hh^T
    streamed), forced, in turns, with the model's step of each: whether
    the model's pick is the faster."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_wide_scan as PW
    h, t_len, rows = HIDDEN, TRAIN_T, TRAIN_ROWS
    w_hh = _uniform(gen, dev, (h, 3 * h), h ** -0.5)
    b_hh = _uniform(gen, dev, (3 * h,), h ** -0.5)
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    plan = G.card_gru_wide_plan(dev, h, rows)
    one = min((p for p in (PW.wide_plan(h, rows, 8, 160, None, stages, dev,
                                        "gru") for stages in (2, 3, 4))
               if p is not None), key=lambda p: p.step_us)

    def timed(p):
        def run():
            with PW.forced(p), torch.no_grad():
                return G.gru_scan_tm(gates, w_hh, b_hh)
        return run

    with torch.no_grad(), L.wide_forwards():
        want = G.gru_scan_tm(gates, w_hh, b_hh)
    check(torch.equal(timed(one)(), want), "the one-wave wide plan == the "
          "planner's bitwise at 2304 rows")
    rounds = [cuda_ms(timed(p), iters=3) for p in (plan, one, one, plan)]
    ms, ms_one = min(rounds[0], rounds[3]), min(rounds[1:3])
    log(f"GRU wide at T={t_len} rows={rows} H={h}: the planner's "
        f"{_wide_plan_line(plan)} {ms:.3f} ms (modelled "
        f"{plan.waves * plan.step_us * t_len / 1e3:.3f}); one wave "
        f"{_wide_plan_line(one)} {ms_one:.3f} ms (modelled "
        f"{one.waves * one.step_us * t_len / 1e3:.3f}); rounds "
        f"{' '.join(f'{r:.3f}' for r in rounds)}; the model picks the "
        f"{'faster' if ms <= ms_one * 1.02 else 'SLOWER'}; on {card}")
    del gates, want
    torch.cuda.empty_cache()
    return dict(ms=ms, one_wave_ms=ms_one, one_wave=dataclasses.asdict(one))


def _gru_fwd_wide_path(dev, v1_gru):
    """FullSubNet v1-GRU on the route, the counts set to 0 around each
    part: the batched 8 x 10 s forward (the sub-band GRU over 2056 rows,
    the full band over 8), profiled, with exact launches; then its bf16
    training step (18 x 3.072 s: the sub-band GRU over 2304 rows, the full
    band over 18) on the route beside resident_forwards() in turns
    (GRU_FWD_WIDE_STEPS steps each: route, resident, resident, route),
    exact launches, medians and a profile of each (_steps_in_turns).
    Returns the launches of both and the readings."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.ops import prepare_input_from_waveform
    model = v1_gru.model(torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 300)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    batch = prepare_input_from_waveform(wav, 512, 256, 512)[:v1_gru.n_inputs]
    expected = forward_counts(v1_gru, 8)
    launched = {}
    with torch.inference_mode():
        model(*batch)
        torch.cuda.synchronize()
        L.reset_launch_counts()
        model(*batch)
        torch.cuda.synchronize()
        got = {k: n for k, n in L.launch_counts.items() if n}
        check(got == expected, f"v1-GRU's batched 8 x 10 s forward launched "
              f"{expected}, the route's (got {got})")
        for k, n in got.items():
            launched[k] = launched.get(k, 0) + n
        fwd_profile = _profile(lambda: model(*batch), "FullSubNet v1-GRU batch "
                               f"8 x 10 s forward on the route ({expected})")
        with L.resident_forwards():
            res_profile = _profile(lambda: model(*batch), "FullSubNet v1-GRU "
                                   "batch 8 x 10 s forward under "
                                   "resident_forwards()")
    del model
    torch.cuda.empty_cache()
    res = _steps_in_turns(dev, v1_gru, L.resident_forwards,
                          GRU_FWD_WIDE_STEPS, "phase 30's path")
    out = {"forward": {}, "route_ms": res["route"]["median_ms"],
           "resident_ms": res["witness"]["median_ms"]}
    for part, (wall, busy, rows) in (("route", fwd_profile),
                                     ("resident", res_profile)):
        out["forward"][part] = dict(
            profiled_ms=wall, busy_ms=busy,
            gru_fwd_ms=sum(ms for key, ms, _ in rows
                           if "gru_wide_kernel" in key
                           or "gru_cluster_kernel" in key))
    for part, r in res.items():
        wall, busy, rows = r["profile"]
        key = "route" if part == "route" else "resident"
        out[key] = dict(profiled_ms=wall, busy_ms=busy,
                        gru_fwd_ms=sum(ms for k, ms, _ in rows
                                       if "gru_wide_kernel" in k
                                       or "gru_cluster_kernel" in k),
                        peak_gib=r["peak_gib"], per_step=r["per_step"])
        for k, n in r["launched"].items():
            launched[k] = launched.get(k, 0) + n
    log(f"phase 30 (c) FullSubNet v1-GRU batch 8 x 10 s forward: profiled "
        + "; ".join(f"{part} {r['profiled_ms']:.2f} ms, busy "
                    f"{r['busy_ms']:.2f} ({100 * r['busy_ms'] / r['profiled_ms']:.1f}%),"
                    f" GRU forwards {r['gru_fwd_ms']:.2f} ms"
                    for part, r in out["forward"].items()))
    log(f"phase 30 (c) FullSubNet v1-GRU bf16 step, batch {TRAIN_BATCH} x "
        f"{TRAIN_SAMPLES / 16000:.3f} s: on the route "
        f"({res['route']['per_step']} a step) median {out['route_ms']:.2f} ms "
        f"of {_times_line(res['route']['times'])}; resident_forwards() "
        f"({res['witness']['per_step']}) {out['resident_ms']:.2f} ms of "
        f"{_times_line(res['witness']['times'])}; profiled: " + "; ".join(
            f"{part} {r['profiled_ms']:.2f} ms, busy {r['busy_ms']:.2f} "
            f"({100 * r['busy_ms'] / r['profiled_ms']:.1f}%), GRU forwards "
            f"{r['gru_fwd_ms']:.2f} ms, peak memory {r['peak_gib']:.2f} GiB"
            for part, r in (("route", out["route"]),
                            ("resident", out["resident"])))
        + f"; on {card_line()}")
    return launched, out


def phase_gru_wide_forwards(dev, registers):
    """Phase 30: the GRU forward and carry (TPU rows 6 and 8) as wide
    clusters. (a) No instance spills; both entries bit for bit against the
    resident cluster at 2056, a ragged 2047 and 257 rows x T=628, 2304, a
    ragged 2295 and 1024 rows x T=195 and H=512 x 18 x 195 and x 8 x 628
    (forward and reverse, bf16 and fp32 out, the carry from a state and in
    chunks of 64 against unchunked, two runs of the forward against each
    other), within the GRU forward's limits of the plain versions; (b)
    timed at 2056 x 628 (both entries), 2304 x 195, 257 x 628 and the full
    band's 18 x 195 beside the resident cluster in turns, the plain
    version, cuDNN's nn.GRU and the bound, with both plans and the route's
    pick, failing where the route takes the slower design; the planner's
    plan at 2304 rows against the one-wave plan of 160 rows; (c) the path:
    FullSubNet v1-GRU's batched 8 x 10 s forward, profiled on the route
    and under resident_forwards(), and its bf16 training step on the route
    beside resident_forwards() in turns, exact launches, medians and
    profiles. Returns the entries' numbers and their launches on (c)."""
    from generative_audio_torch.ops import gru as G
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    card = card_line()
    wide = {k: v for k, v in registers.items() if k.startswith("gru wide")}
    log(f"GRU wide instances: " + (", ".join(
        f"{k} {n}" for k, n in sorted(wide.items()))
        or "not rebuilt in this run"))
    check(all(v.endswith(" 0/0 B spilled") for v in wide.values()),
          "no GRU wide instance spills")
    gen = torch.Generator(device=dev).manual_seed(SEED + 301)
    worst = _gru_fwd_wide_identities(dev, G, gen)
    kernels = _gru_fwd_wide_times(dev, G, gen, HIDDEN, T_FRAMES, ROWS, card)
    for key, (h, t_len, rows) in (("train", (HIDDEN, TRAIN_T, TRAIN_ROWS)),
                                  ("request", (HIDDEN, T_FRAMES, ROWS // 8)),
                                  ("full_band", (FB_HIDDEN, TRAIN_T,
                                                 TRAIN_BATCH))):
        kernels[GRU_FWD_WIDE[0]][key] = _gru_fwd_wide_times(
            dev, G, gen, h, t_len, rows, card, carry=False)[GRU_FWD_WIDE[0]]
    kernels[GRU_FWD_WIDE[0]]["train"]["planner"] = _gru_one_wave_at_2304(
        dev, G, gen, card)
    for name in GRU_FWD_WIDE:
        kernels[name]["max_abs_err"], kernels[name]["mean_abs_err"] = \
            worst[name]
    _, v1_gru, _ = model_paths()
    launches, kernels[GRU_FWD_WIDE[0]]["path"] = _gru_fwd_wide_path(dev,
                                                                   v1_gru)
    log(f"launches on phase 30's path: {launches}; phase 30 "
        f"{time.perf_counter() - t0:.1f} s")
    for rows, what in ((ROWS, "serving"), (TRAIN_ROWS, "training")):
        check(routed("gru_scan_fwd", rows) == GRU_FWD_WIDE[0]
              and launches.get(GRU_FWD_WIDE[0], 0) > 0,
              f"{GRU_FWD_WIDE[0]} is the route at v1's {rows} sub-band "
              f"{what} rows and launched on phase 30's path")
    return kernels, {k: launches.get(k, 0) for k in GRU_FWD_ENTRIES}


def _gru_library(w_hh, b_hh):
    """cuDNN's GRU on the same x-side gates: nn.GRU(3H, H) with W_ih = I and
    b_ih = 0, so each step computes what the kernels do, plus one extra
    [T*rows, 3H] x [3H, 3H] projection."""
    h = w_hh.shape[0]
    gru = torch.nn.GRU(3 * h, h, device=w_hh.device, dtype=torch.bfloat16)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * h))
        gru.weight_hh_l0.copy_(w_hh.t())
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.copy_(b_hh)
    return gru


def library_gru_ms(gates, w_hh, b_hh):
    """The cuDNN GRU of _gru_library, inference. Timed only."""
    gru = _gru_library(w_hh, b_hh)
    with torch.no_grad():
        return cuda_ms(lambda: gru(gates), iters=5)


def library_gru_train_ms(gates, w_hh, b_hh, gout):
    """The cuDNN GRU of _gru_library in training mode: the forward alone,
    and the forward plus the backward to the gates and the weights. Timed
    only."""
    gru = _gru_library(w_hh, b_hh)
    x = gates.detach().requires_grad_()

    def both():
        gru(x)[0].backward(gout)
        x.grad = None
        gru.zero_grad(set_to_none=True)

    return cuda_ms(lambda: gru(x), iters=5), cuda_ms(both, iters=5)


def library_dwhh_ms(h_prev, dgates_h):
    """One torch.mm with bf16 operands and fp32 output on the rows the dW_hh
    contraction takes. Timed only."""
    return cuda_ms(lambda: torch.mm(h_prev.t(), dgates_h,
                                    out_dtype=torch.float32), iters=5)


def _gru_chunked(G, gates, w_hh, b_hh, reverse, out_dtype):
    """The carry kernel over chunks of T_CHUNK frames (the last one ragged)."""
    t_len, rows = gates.shape[:2]
    hs = torch.zeros(rows, w_hh.shape[0], device=gates.device)
    out = torch.empty(t_len, rows, w_hh.shape[0], dtype=out_dtype,
                      device=gates.device)
    starts = list(range(0, t_len, T_CHUNK))
    for s in (starts[::-1] if reverse else starts):
        e = min(s + T_CHUNK, t_len)
        out[s:e], hs = G.gru_scan_carry_tm(gates[s:e], w_hh, b_hh, hs, reverse,
                                           out_dtype)
    return out


def _plan_line(M, dev, h, rows, **instance):
    """A cluster scan's launch plan at (H, rows) on the card: M is ops.lstm
    (kernels A-C; instance flags out_dtype, carry, train) or ops.gru (the
    GRU forward; out_dtype, carry)."""
    plan = M.card_scan_plan(dev, h, rows, **instance)
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, {plan.clusters} "
            f"clusters, route DSMEM, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
            f"shared memory a CTA")


def _bwd_plan_line(M, dev, h, rows):
    """The backward scan's launch plan at (H, rows) on the card: M is
    ops.lstm (kernel D) or ops.gru (the GRU backward scan)."""
    plan = M.card_bwd_scan_plan(dev, h, rows)
    return _describe_bwd(plan)


def _describe_bwd(plan):
    if plan.design == "wide" and not hasattr(plan, "tiles"):
        return (f"wide cluster (wgmma) C={plan.cluster} x R={plan.rows} rows "
                f"at H={plan.hidden}, {plan.warpgroups} warpgroups, a ring of "
                f"{plan.stages} slots, {plan.clusters} clusters, "
                f"cudaOccupancyMaxActiveClusters {plan.active}, {plan.waves} "
                f"wave(s), {plan.smem_bytes} B of shared memory a CTA, "
                f"modelled {plan.step_us:.2f} us a step")
    if plan.design == "wide":
        return (f"wide cluster C={plan.cluster} x R={plan.rows} rows at "
                f"H={plan.hidden}, items {plan.tiles}x{plan.groups}, "
                f"{plan.resident} k-steps resident, {plan.stages} stages, "
                f"{plan.pieces} dgates pieces, {plan.clusters} clusters, "
                f"cudaOccupancyMaxActiveClusters {plan.active}, {plan.waves} "
                f"wave(s), {plan.smem_bytes} B of shared memory a CTA, "
                f"modelled {plan.step_us:.2f} us a step")
    if plan.design == "stream":
        return (f"streamed cluster C={plan.cluster} x R={plan.rows} rows at "
                f"H={plan.hidden}, {plan.resident} slots of each operand "
                f"resident, rings of {plan.stages}, "
                f"{'the whole dgates tile' if plan.tile else 'the slices read in place'}"
                f", {plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
                f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
                f"shared memory a CTA, modelled {plan.step_us:.2f} us a step")
    if plan.design == "block":
        return (f"single block, {plan.clusters} blocks of 16 rows, "
                f"{plan.active} at once, {plan.waves} wave(s), "
                f"{plan.smem_bytes} B of shared memory a block, modelled "
                f"{plan.step_us:.2f} us a step")
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, recompute's "
            f"W_hh^T slice {'resident' if plan.resident else 'from L2'}, "
            f"{plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
            f"shared memory a CTA, modelled {plan.step_us:.2f} us a step")


def _block_bwd_plan(M, dev, h, rows):
    """The single-block design's plan at (H, rows): the planner with no
    cluster to choose from."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return M.plan_bwd_scan(h, rows, lambda c, r, resident: 0, sms)


def _plan_json(L, dev, h, rows, **instance):
    """The plan of kernels A-C at (H, rows) for the kernels line."""
    return dataclasses.asdict(L.card_scan_plan(dev, h, rows, **instance))


def phase_gru_kernels(dev):
    """The GRU forward and carry kernels at the sub-band serving shape and
    at the full-band serving and training shapes."""
    from generative_audio_torch.ops import gru as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    max_f = max_c = 0.0
    weights = {}
    for h, row_counts, t_len in ((HIDDEN, (ROWS, RAGGED_ROWS), T_FRAMES),
                                 (FB_HIDDEN, (FB_SERVE_ROWS, 1), T_FRAMES),
                                 (FB_HIDDEN, (TRAIN_BATCH,), TRAIN_T)):
        if h not in weights:
            weights[h] = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                          _uniform(gen, dev, (3 * h,), h ** -0.5))
        w_hh, b_hh = weights[h]
        for rows in row_counts:
            gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            for reverse in (False, True):
                tag = f"H={h} T={t_len} rows={rows} reverse={reverse}"
                got = G.gru_scan_tm(gates, w_hh, b_hh, reverse, torch.float32)
                want = G.gru_scan_reference_tm(gates, w_hh, b_hh, reverse)
                torch.cuda.synchronize()
                err = (got - want).abs()
                log(f"GRU forward {tag}: max|err| {err.max().item():.3e} mean "
                    f"{err.mean().item():.3e}")
                check(torch.isfinite(got).all().item(),
                      f"GRU forward output finite ({tag})")
                check(err.max().item() < KERNEL_MAX_ABS
                      and err.mean().item() < GRU_FWD_MEAN_ABS,
                      f"GRU forward vs plain within {KERNEL_MAX_ABS}/"
                      f"{GRU_FWD_MEAN_ABS} ({tag})")
                max_f = max(max_f, err.max().item())

                for out_dtype in (torch.bfloat16, torch.float32):
                    whole = G.gru_scan_tm(gates, w_hh, b_hh, reverse, out_dtype)
                    chunked = _gru_chunked(G, gates, w_hh, b_hh, reverse,
                                           out_dtype)
                    check(torch.equal(chunked, whole),
                          f"GRU carry in chunks == forward bitwise ({tag} "
                          f"{out_dtype})")
                log(f"GRU carry, chunks of {T_CHUNK} == forward bitwise ({tag}, "
                    f"bf16 and fp32 out)")

                # the carry kernel against its plain version from a state
                h0 = _uniform(gen, dev, (rows, h), 1.0)
                seq, h_t = G.gru_scan_carry_tm(gates[:T_CHUNK], w_hh, b_hh, h0,
                                               reverse, torch.float32)
                p_seq, p_h = G.gru_scan_carry_reference_tm(
                    gates[:T_CHUNK], w_hh, b_hh, h0, reverse)
                err_c = max((seq - p_seq).abs().max().item(),
                            (h_t - p_h).abs().max().item())
                log(f"GRU carry {tag} from h0: max|err| {err_c:.3e}")
                check(err_c < KERNEL_MAX_ABS, f"GRU carry vs plain ({tag})")
                max_c = max(max_c, err_c)
            del gates

    # times at the sub-band serving shape, bf16 out as the path runs them
    h = HIDDEN
    w_hh, b_hh = weights[h]
    gates = torch.randn(T_FRAMES, ROWS, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    zeros = torch.zeros(ROWS, h, device=dev)
    ms_f = cuda_ms(lambda: G.gru_scan_tm(gates, w_hh, b_hh), iters=5)
    ms_c = cuda_ms(lambda: _gru_chunked(G, gates, w_hh, b_hh, False,
                                        torch.bfloat16), iters=5)
    ms_c_one = cuda_ms(lambda: G.gru_scan_carry_tm(gates, w_hh, b_hh, zeros),
                       iters=5)
    plain_f = cuda_ms(lambda: G.gru_scan_reference_tm(gates, w_hh, b_hh),
                      iters=2)
    plain_c = cuda_ms(lambda: [G.gru_scan_carry_reference_tm(
        gates[s:s + T_CHUNK], w_hh, b_hh, zeros)
        for s in range(0, T_FRAMES, T_CHUNK)], iters=2)
    library = library_gru_ms(gates, w_hh, b_hh)
    n_chunks = -(-T_FRAMES // T_CHUNK)
    # gates in (3 streams of H), h out (1), W_hh, b_hh; the carry also reads
    # and writes the fp32 state once per chunk
    b_f, by_f = bound(T_FRAMES, ROWS, h, streams=4, gates=3,
                      extra_bytes=3 * h * 4)
    b_c, by_c = bound(T_FRAMES, ROWS, h, streams=4, gates=3,
                      extra_bytes=3 * h * 4 + n_chunks * 2 * ROWS * h * 4)
    card = card_line()
    log(f"GRU forward at T={T_FRAMES} rows={ROWS} H={h}: {ms_f:.3f} ms, "
        f"{1e3 * ms_f / T_FRAMES:.2f} us a step (bound {b_f:.3f} ms by "
        f"{by_f}; plain {plain_f:.3f} ms; cuDNN GRU {library:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(G, dev, h, ROWS)}")
    log(f"GRU carry, {n_chunks} chunks of {T_CHUNK}: {ms_c:.3f} ms, "
        f"{1e3 * ms_c / T_FRAMES:.2f} us a step (bound {b_c:.3f} ms by {by_c}; "
        f"plain {plain_c:.3f} ms); in one chunk of {T_FRAMES}: {ms_c_one:.3f} "
        f"ms on {card}")
    log(f"  plan: {_plan_line(G, dev, h, ROWS, carry=True)}")
    log("  (the cuDNN GRU is nn.GRU(3H, H) with W_ih = I and b_ih = 0: the "
        "same recurrence plus one extra [T*rows, 3H] x [3H, 3H] projection)")
    del gates
    # the full-band shapes: one cluster
    h = FB_HIDDEN
    w_hh, b_hh = weights[h]
    for rows, t_len, what in ((FB_SERVE_ROWS, T_FRAMES, "serving"),
                              (TRAIN_BATCH, TRAIN_T, "training")):
        gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        ms_fb = cuda_ms(lambda: G.gru_scan_tm(gates, w_hh, b_hh), iters=5)
        plain_fb = cuda_ms(lambda: G.gru_scan_reference_tm(gates, w_hh, b_hh),
                           iters=2)
        lib_fb = library_gru_ms(gates, w_hh, b_hh)
        b_fb, by_fb = bound(t_len, rows, h, streams=4, gates=3,
                            extra_bytes=3 * h * 4)
        log(f"GRU forward at T={t_len} rows={rows} H={h} (full band, "
            f"{what}): {ms_fb:.3f} ms, {1e3 * ms_fb / t_len:.2f} us a step "
            f"(bound {b_fb:.4f} ms by {by_fb}; plain {plain_fb:.3f} ms; cuDNN "
            f"GRU {lib_fb:.3f} ms) on {card}")
        log(f"  plan: {_plan_line(G, dev, h, rows)}")
        del gates
    return {
        "gru_scan_fwd": dict(
            max_abs_err=max_f, ms=ms_f, plain_ms=plain_f, bound_ms=b_f,
            bound_by=by_f, library_ms=library),
        "gru_scan_fwd_carry": dict(
            max_abs_err=max_c, ms=ms_c, plain_ms=plain_c, bound_ms=b_c,
            bound_by=by_c, library_ms=library)}


def _rel_norm(got, want):
    return ((got - want).norm() / want.norm()).item()


def phase_gru_train_kernels(dev, registers):
    """The GRU backward (scan + dW_hh contraction) at the training shapes,
    the scan's plan (a cluster) against the single block bit for bit (dgx,
    dhn and every db_hh partial), and the GRUScan gradient as a whole; the
    scan's times at the sub-band and full-band training shapes."""
    from generative_audio_torch.ops import gru as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    t_len = TRAIN_T
    max_d = max_w = 0.0
    weights = {}
    for h, rows in ((HIDDEN, TRAIN_ROWS), (HIDDEN, TRAIN_RAGGED_ROWS),
                    (FB_HIDDEN, TRAIN_BATCH)):
        if h not in weights:
            weights[h] = (_uniform(gen, dev, (h, 3 * h), h ** -0.5),
                          _uniform(gen, dev, (3 * h,), h ** -0.5))
        w_hh, b_hh = weights[h]
        for reverse in (False, True):
            gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            gout = torch.randn(t_len, rows, h, generator=gen,
                               device=dev).to(torch.bfloat16)
            tag = f"H={h} rows={rows} reverse={reverse}"
            # the forward as GRUScan launches it, at this shape
            with torch.no_grad():
                h_seq = G.gru_scan_tm(gates, w_hh, b_hh, reverse)
            # against the plain version rounded to bf16 as the kernel rounds
            # its output: a difference that crosses a rounding boundary shows
            # as one bf16 step of |h| < 1 (3.9e-3), under KERNEL_MAX_ABS
            err_f = (h_seq.float() - G.gru_scan_reference_tm(
                gates, w_hh, b_hh, reverse).to(torch.bfloat16).float()).abs()
            log(f"GRU forward {tag} T={t_len}, bf16 out: max|err| "
                f"{err_f.max().item():.3e} mean {err_f.mean().item():.3e}")
            check(err_f.max().item() < KERNEL_MAX_ABS
                  and err_f.mean().item() < GRU_FWD_MEAN_ABS,
                  f"GRU forward vs plain within {KERNEL_MAX_ABS}/"
                  f"{GRU_FWD_MEAN_ABS} at the training shape ({tag})")
            del err_f
            dgx, dw, db = G.gru_scan_bwd_tm(gates, h_seq, gout, w_hh, b_hh,
                                            reverse)
            p_dgx, p_dhn, p_db = G.gru_scan_bwd_streams_reference_tm(
                gates, h_seq, gout, w_hh, b_hh, reverse)
            shifted = G.shifted_rows(h_seq, p_dgx, p_dhn, reverse)
            p_dw = G.gru_dwhh_reference(*shifted)
            # the contraction alone, on the plain version's own streams, twice
            alone = G.gru_dwhh(*shifted)
            repeats = torch.equal(alone, G.gru_dwhh(*shifted))
            torch.cuda.synchronize()
            err_d = (dgx.float() - p_dgx.float()).abs()
            peak = p_dgx.float().abs().max().item()
            rel_w, rel_b = _rel_norm(dw, p_dw), _rel_norm(db, p_db)
            rel_alone = _rel_norm(alone, p_dw)
            log(f"GRU backward {tag}: dgx max|err| {err_d.max().item():.3e} "
                f"mean {err_d.mean().item():.3e} (peak |dgx| {peak:.3f}); dW_hh "
                f"|err|/|dW_hh| {rel_w:.3e}, db_hh {rel_b:.3e}; the contraction "
                f"alone vs a float32 matmul {rel_alone:.3e} (max|err| "
                f"{(alone - p_dw).abs().max().item():.3e}), the same bits in two "
                f"runs: {repeats}")
            check(all(torch.isfinite(x.float()).all().item()
                      for x in (dgx, dw, db)), f"GRU backward finite ({tag})")
            check(err_d.max().item() < BWD_MAX_REL * peak
                  and err_d.mean().item() < BWD_MEAN_REL * peak,
                  f"GRU backward dgx vs plain within {BWD_MAX_REL}/"
                  f"{BWD_MEAN_REL} of the peak ({tag})")
            check(rel_w < BWD_DW_REL and rel_b < BWD_DW_REL,
                  f"GRU backward dW_hh, db_hh vs plain within {BWD_DW_REL} "
                  f"({tag})")
            check(rel_alone < DWHH_ALONE_REL,
                  f"dW_hh contraction vs float32 matmul within "
                  f"{DWHH_ALONE_REL} ({tag})")
            check(repeats, f"dW_hh contraction repeats bit for bit ({tag})")
            max_d = max(max_d, err_d.max().item())
            max_w = max(max_w, (alone - p_dw).abs().max().item())
            del p_dgx, p_dhn, shifted, err_d
            # the card's plan (a cluster) against the single-block design:
            # dgx, dhn and the db_hh partial of every 16-row tile
            got = G.gru_scan_bwd_streams_planned_tm(
                gates, h_seq, gout, w_hh, b_hh,
                G.card_bwd_scan_plan(dev, h, rows), reverse)
            want = G.gru_scan_bwd_streams_planned_tm(
                gates, h_seq, gout, w_hh, b_hh,
                _block_bwd_plan(G, dev, h, rows), reverse)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, want))
                  and torch.equal(got[0], dgx),
                  f"GRU backward scan's plan == the single block bitwise "
                  f"(dgx, dhn, {got[2].shape[0]} db_hh partials; {tag})")
            log(f"GRU backward scan {tag}: plan "
                f"{_bwd_plan_line(G, dev, h, rows)}; == the single block "
                f"bitwise (dgx, dhn, {got[2].shape[0]} db_hh partials)")
            del got, want

            # GRUScan as a whole against autograd through the fp32 recurrence
            kernel_in = [gates.clone().requires_grad_(),
                         w_hh.clone().requires_grad_(),
                         b_hh.clone().requires_grad_()]
            (G.gru_scan_tm(*kernel_in, reverse, torch.float32)
             * gout.float()).sum().backward()
            exact_in = [gates.float().requires_grad_(),
                        w_hh.clone().requires_grad_(),
                        b_hh.clone().requires_grad_()]
            (G.gru_scan_reference_tm(*exact_in, reverse,
                                     compute_dtype=torch.float32)
             * gout.float()).sum().backward()
            torch.cuda.synchronize()
            g_k, w_k, b_k = (x.grad for x in kernel_in)
            g_x, w_x, b_x = (x.grad for x in exact_in)
            check(g_k.dtype == torch.bfloat16 and w_k.dtype == torch.float32
                  and b_k.dtype == torch.float32 and b_k.shape == b_hh.shape,
                  "GRUScan gradient dtypes")
            err_g = (g_k.float() - g_x).abs()
            peak_g = g_x.abs().max().item()
            rel_w, rel_b = _rel_norm(w_k, w_x), _rel_norm(b_k, b_x)
            log(f"GRUScan {tag} vs float32 autograd: d gates max|err|/peak "
                f"{err_g.max().item() / peak_g:.3e} mean/peak "
                f"{err_g.mean().item() / peak_g:.3e}; dW_hh |err|/|dW_hh| "
                f"{rel_w:.3e}; db_hh {rel_b:.3e}")
            check(err_g.max().item() < GRAD_MAX_REL * peak_g
                  and err_g.mean().item() < GRAD_MEAN_REL * peak_g
                  and rel_w < GRAD_DW_REL and rel_b < GRAD_DW_REL,
                  f"GRUScan gradient vs float32 within {GRAD_MAX_REL}/"
                  f"{GRAD_MEAN_REL}/{GRAD_DW_REL} ({tag})")
            del kernel_in, exact_in, err_g, gates, gout

    # times at the sub-band training shape
    h, rows = HIDDEN, TRAIN_ROWS
    w_hh, b_hh = weights[h]
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    with torch.no_grad():
        h_seq = G.gru_scan_tm(gates, w_hh, b_hh)
        ms_f = cuda_ms(lambda: G.gru_scan_tm(gates, w_hh, b_hh), iters=5)
    dgx, dhn, _ = G.gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh, b_hh)
    ms_d = cuda_ms(lambda: G.gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh,
                                                     b_hh), iters=5)
    block = _block_bwd_plan(G, dev, h, rows)
    ms_d_block = cuda_ms(lambda: G.gru_scan_bwd_streams_planned_tm(
        gates, h_seq, gout, w_hh, b_hh, block), iters=3)
    plain_d = cuda_ms(lambda: G.gru_scan_bwd_streams_reference_tm(
        gates, h_seq, gout, w_hh, b_hh), iters=2)
    lib_fwd, lib_both = library_gru_train_ms(gates, w_hh, b_hh, gout)
    # the scan: gx (3) + h_seq + gout in, dgx (3) + dhn out, W_hh and b_hh
    # in, db_hh out; two products per step. The per-block db_hh partials and
    # the second layout of W_hh are the design's own and not counted.
    b_d, by_d = bound(t_len, rows, h, streams=9, products=2, gates=3,
                      extra_bytes=2 * 3 * h * 4)
    card = card_line()
    log(f"GRU forward at T={t_len} rows={rows} H={h} (the forward under grad): "
        f"{ms_f:.3f} ms, {1e3 * ms_f / t_len:.2f} us a step (cuDNN GRU "
        f"forward, training mode, {lib_fwd:.3f} ms) on {card}")
    log(f"  plan: {_plan_line(G, dev, h, rows)}")
    log(f"GRU backward scan at T={t_len} rows={rows} H={h}: {ms_d:.3f} ms, "
        f"{1e3 * ms_d / t_len:.2f} us a step (the single-block design "
        f"{ms_d_block:.3f} ms; bound {b_d:.3f} ms by {by_d}; plain "
        f"{plain_d:.3f} ms; cuDNN GRU backward {lib_both - lib_fwd:.3f} "
        f"ms = forward + backward {lib_both:.3f} ms less the forward, dW_hh "
        f"and db_hh included) on {card}")
    log(f"  plan: {_bwd_plan_line(G, dev, h, rows)}; registers "
        f"{_registers_line(registers, 'G')}")
    scan_plan = dataclasses.asdict(G.card_bwd_scan_plan(dev, h, rows))
    contraction = _time_dwhh(G, h_seq, dgx, dhn, card)
    del gates, gout, h_seq, dgx, dhn
    # the contraction at the full-band training shape
    h, rows = FB_HIDDEN, TRAIN_BATCH
    w_hh, b_hh = weights[h]
    gates = torch.randn(t_len, rows, 3 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    with torch.no_grad():
        h_seq = G.gru_scan_tm(gates, w_hh, b_hh)
    dgx, dhn, _ = G.gru_scan_bwd_streams_tm(gates, h_seq, gout, w_hh, b_hh)
    _time_dwhh(G, h_seq, dgx, dhn, card)
    # the scan at the full-band training shape: both designs, bound, plain
    # version and cuDNN's backward
    ms_fb = cuda_ms(lambda: G.gru_scan_bwd_streams_tm(gates, h_seq, gout,
                                                      w_hh, b_hh), iters=10)
    block = _block_bwd_plan(G, dev, h, rows)
    ms_fb_block = cuda_ms(lambda: G.gru_scan_bwd_streams_planned_tm(
        gates, h_seq, gout, w_hh, b_hh, block), iters=3)
    plain_fb = cuda_ms(lambda: G.gru_scan_bwd_streams_reference_tm(
        gates, h_seq, gout, w_hh, b_hh), iters=2)
    lib_fwd_fb, lib_both_fb = library_gru_train_ms(gates, w_hh, b_hh, gout)
    b_fb, by_fb = bound(t_len, rows, h, streams=9, products=2, gates=3,
                        extra_bytes=2 * 3 * h * 4)
    log(f"GRU backward scan at T={t_len} rows={rows} H={h} (full band, "
        f"training batch): {ms_fb:.3f} ms, {1e3 * ms_fb / t_len:.2f} us a step "
        f"(the single-block design {ms_fb_block:.3f} ms; bound {b_fb:.4f} ms "
        f"by {by_fb}; plain {plain_fb:.3f} ms; cuDNN GRU backward "
        f"{lib_both_fb - lib_fwd_fb:.3f} ms, dW_hh and db_hh included) on "
        f"{card}")
    log(f"  plan: {_bwd_plan_line(G, dev, h, rows)}")
    return {
        "gru_scan_bwd": dict(
            max_abs_err=max_d, ms=ms_d, plain_ms=plain_d, bound_ms=b_d,
            bound_by=by_d, library_ms=lib_both - lib_fwd,
            single_block_ms=ms_d_block, plan=scan_plan,
            full_band=dict(
                ms=ms_fb, single_block_ms=ms_fb_block, plain_ms=plain_fb,
                bound_ms=b_fb, bound_by=by_fb,
                library_ms=lib_both_fb - lib_fwd_fb,
                plan=dataclasses.asdict(G.card_bwd_scan_plan(dev, h, rows)))),
        "gru_scan_bwd_dwhh": dict(max_abs_err=max_w, **contraction)}


def _time_dwhh(G, h_seq, dgx, dhn, card):
    """The dW_hh contraction over the shifted rows of one layer's streams:
    its time (the slices' sum included), bound, plain version and one
    torch.mm."""
    h = h_seq.shape[-1]
    h_prev, dg, dn = G.shifted_rows(h_seq, dgx, dhn, False)
    n = h_prev.shape[0]
    ms_w = cuda_ms(lambda: G.gru_dwhh(h_prev, dg, dn), iters=10)
    plain_w = cuda_ms(lambda: G.gru_dwhh_reference(h_prev, dg, dn), iters=2)
    lib_w = library_dwhh_ms(h_prev, torch.cat([dg[:, :2 * h], dn], dim=-1))
    # h_prev, the 2H columns of dgx it needs and dhn in, one fp32 [H, 3H]
    # out (the per-slice partials are the design's own)
    b_w, by_w = _larger(n * 4 * h * 2 + h * 3 * h * 4, 2 * n * h * 3 * h)
    plan = G.plan_dwhh(n, h, G._device_sms(h_prev.device))
    log(f"GRU dW_hh contraction at H={h} over N={n} rows, {plan.tiles} tiles "
        f"x {plan.slices} slices of {plan.rows_per_slice} rows (narrow "
        f"{plan.narrow_tiles} x {plan.narrow_slices}) and their sum: "
        f"{ms_w:.3f} ms (bound {b_w:.3f} ms by {by_w}; plain {plain_w:.3f} ms; "
        f"torch.mm with fp32 output {lib_w:.3f} ms) on {card}")
    return dict(ms=ms_w, plain_ms=plain_w, bound_ms=b_w, bound_by=by_w,
                library_ms=lib_w)


def library_layer_ms(x, w_ih, w_hh, bias):
    """cuDNN's LSTM, nn.LSTM(F, H) in bf16, on x [T, B, F] with the layer's
    own weights (b_ih = bias, b_hh = 0): the same function as lstm_layer_tm,
    projection included. Timed only."""
    h = w_hh.shape[0]
    lstm = torch.nn.LSTM(w_ih.shape[0], h, device=x.device, dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
        return cuda_ms(lambda: lstm(x), iters=5)


def _layer_bound(t, rows, f, h):
    """Least time (ms) of one layer with the projection inside: x and h
    streams and the weights in bf16, the fp32 bias; 2*(F + H)*4H operations
    per row and step."""
    return _larger(t * rows * (f + h) * 2 + (f + h) * 4 * h * 2 + 4 * h * 4,
                   2 * t * rows * (f + h) * 4 * h)


def _sub_band_stack(dev, path):
    """FullSubNet+'s sub-band LSTM stack on one batch-8 x 10 s request: its
    layer-1 input [T, rows, 34] (float32), the stack's own bf16 output and
    the two layers' (w_ih [F, 4H], w_hh [H, 4H], b_ih + b_hh)."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    model = path.model(torch.bfloat16, dev)
    stack = model.sb_model.sequence_model
    seen = {}
    hooks = [stack.register_forward_pre_hook(
                 lambda m, args: seen.setdefault("x", args[0])),
             stack.register_forward_hook(
                 lambda m, args, y: seen.setdefault("y", y))]
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    with torch.no_grad():
        model(*prepare_input_from_waveform(wav, 512, 256, 512)[:path.n_inputs])
        weights = [tuple(w.detach().clone() for w in (
            getattr(stack, f"weight_ih_l{i}").t(),
            getattr(stack, f"weight_hh_l{i}").t(),
            getattr(stack, f"bias_ih_l{i}") + getattr(stack, f"bias_hh_l{i}")))
            for i in range(2)]
    for hook in hooks:
        hook.remove()
    return seen["x"], seen["y"], weights


def _check_layer(L, tag, x, weights, reverse):
    """lstm_layer_fwd and its single block, lstm_layer_fwd_block (fp32 out
    both), against the plain version; (max |err| of each)."""
    want = L.lstm_layer_reference_tm(x, *weights, reverse)
    errs = []
    for name in ("lstm_layer_fwd", "lstm_layer_fwd_block"):
        with (L.single_block_forwards() if name.endswith("_block")
              else contextlib.nullcontext()):
            got = L.lstm_layer_tm(x, *weights, reverse, torch.float32)
        torch.cuda.synchronize()
        err = (got - want).abs()
        log(f"{name} {tag} reverse={reverse}: max|err| "
            f"{err.max().item():.3e} mean {err.mean().item():.3e}")
        check(torch.isfinite(got).all().item(), f"{name} finite ({tag})")
        check(err.max().item() < KERNEL_MAX_ABS
              and err.mean().item() < KERNEL_MEAN_ABS,
              f"{name} vs plain within {KERNEL_MAX_ABS}/{KERNEL_MEAN_ABS} "
              f"({tag} reverse={reverse})")
        errs.append(err.max().item())
    return tuple(errs)


def _layer_routes_agree(L, inp, weights, reverse):
    """lstm_layer_tm (fp32 out) on the card's route (the cluster) and on
    the single block (the first design of kernel F): bit for bit?"""
    with torch.no_grad():
        got = L.lstm_layer_tm(inp, *weights, reverse, torch.float32)
        with L.single_block_forwards():
            blk = L.lstm_layer_tm(inp, *weights, reverse, torch.float32)
    torch.cuda.synchronize()
    return torch.equal(got, blk)


def phase_lstm_layer(dev, path, kernel_a_ms, registers):
    """Row 4: lstm_layer_tm through FullSubNet+'s sub-band stack, its plain
    version, the model's hoisted stack, the cluster against the single block
    (`lstm_layer_fwd_block`, the first design) bit for bit, its gradient at
    the training shape, and its times beside the single block's, with its
    plans and registers."""
    from generative_audio_torch.ops import lstm as L
    x, hoisted, weights = _sub_band_stack(dev, path)
    check(tuple(x.shape) == (T_FRAMES, ROWS, SB_FEATURES),
          f"the sub-band input is [{T_FRAMES}, {ROWS}, {SB_FEATURES}] "
          f"(got {tuple(x.shape)})")

    # the path: both layers through the entry point, bf16 as a user runs it
    L.reset_launch_counts()
    with torch.no_grad():
        y1 = L.lstm_layer_tm(x, *weights[0])
        y2 = L.lstm_layer_tm(y1, *weights[1])
    torch.cuda.synchronize()
    launches = dict(L.launch_counts)
    check(launches == {**dict.fromkeys(launches, 0), "lstm_layer_fwd": 2},
          f"the two layers launched lstm_layer_fwd twice and nothing else "
          f"(got {launches})")
    err = (y2.float() - hoisted.float()).abs()
    log(f"lstm_layer_tm x 2 over FullSubNet+'s sub-band input [{T_FRAMES}, "
        f"{ROWS}, {SB_FEATURES}] vs the model's hoisted stack: max|err| "
        f"{err.max().item():.3e} mean {err.mean().item():.3e}")
    check(torch.isfinite(y2.float()).all().item()
          and err.max().item() < LAYER_PATH_MAX_ABS
          and err.mean().item() < LAYER_PATH_MEAN_ABS,
          f"lstm_layer_tm stack vs the hoisted stack within "
          f"{LAYER_PATH_MAX_ABS}/{LAYER_PATH_MEAN_ABS}")
    del err

    max_err = max_err_blk = 0.0
    with torch.no_grad():
        ragged = x[:TRAIN_T, :RAGGED_ROWS]
        for tag, inp, w in (("layer 1", x, weights[0]),
                            ("layer 2", y1, weights[1]),
                            (f"layer 1 T={TRAIN_T} rows={RAGGED_ROWS}",
                             ragged, weights[0])):
            tag = f"{tag} (F={inp.shape[-1]})"
            for reverse in (False, True):
                err, err_blk = _check_layer(L, tag, inp, w, reverse)
                max_err, max_err_blk = (max(max_err, err),
                                        max(max_err_blk, err_blk))

    # the cluster against the single block, the parent design, bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    fb = FB_HIDDEN
    x512 = torch.randn(T_CHUNK, 40, HIDDEN, generator=gen, device=dev)
    w512 = (_uniform(gen, dev, (HIDDEN, 4 * fb), fb ** -0.5),
            _uniform(gen, dev, (fb, 4 * fb), fb ** -0.5),
            _uniform(gen, dev, (4 * fb,), fb ** -0.5))
    for tag, inp, w in (("layer 1", x, weights[0]), ("layer 2", y1, weights[1]),
                        (f"layer 1 T={TRAIN_T} rows={RAGGED_ROWS}",
                         x[:TRAIN_T, :RAGGED_ROWS], weights[0]),
                        (f"H={fb} F={HIDDEN} T={T_CHUNK} rows=40", x512,
                         w512)):
        for reverse in (False, True):
            check(_layer_routes_agree(L, inp, w, reverse),
                  f"lstm_layer_fwd == lstm_layer_fwd_block bitwise ({tag}, "
                  f"reverse={reverse})")
        log(f"lstm_layer_fwd == lstm_layer_fwd_block bitwise, fp32 out, "
            f"forward and reverse: {tag}")
    del x512, w512

    # times at both layers, on bf16 inputs as the stack hands them on: the
    # cluster and the single block in turns (cluster, block, block, cluster)
    x_bf = x.to(torch.bfloat16).contiguous()
    card = card_line()
    times, block_times = {}, {}
    with torch.no_grad():
        for name, inp, w in (("layer 1", x_bf, weights[0]),
                             ("layer 2", y1, weights[1])):
            f = inp.shape[-1]

            def block():
                with L.single_block_forwards():
                    return L.lstm_layer_tm(inp, *w)

            rounds = [cuda_ms(lambda: L.lstm_layer_tm(inp, *w), iters=5),
                      cuda_ms(block, iters=3), cuda_ms(block, iters=3),
                      cuda_ms(lambda: L.lstm_layer_tm(inp, *w), iters=5)]
            ms, ms_blk = min(rounds[0], rounds[3]), min(rounds[1:3])
            plain = cuda_ms(lambda: L.lstm_layer_reference_tm(inp, *w), iters=2)
            lib = library_layer_ms(inp, *w)
            b_ms, by = _layer_bound(T_FRAMES, ROWS, f, HIDDEN)
            plan = L.card_layer_plan(dev, L.layer_route(HIDDEN, f)[0], ROWS, f)
            times[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                               bound_by=by, library_ms=lib,
                               plan=dataclasses.asdict(plan))
            block_times[name] = dict(ms=ms_blk, plain_ms=plain, bound_ms=b_ms,
                                     bound_by=by, library_ms=lib)
            log(f"lstm_layer_fwd {name} at T={T_FRAMES} rows={ROWS} F={f} "
                f"H={HIDDEN}: {ms:.3f} ms, {1e3 * ms / T_FRAMES / plan.waves:.2f} "
                f"us a step a wave (modelled "
                f"{L.layer_step_us(HIDDEN, plan.cluster, plan.rows, f):.2f}); single "
                f"block (lstm_layer_fwd_block, the first design) "
                f"{ms_blk:.3f} ms (rounds {' '.join(f'{r:.3f}' for r in rounds)}); "
                f"{ms / kernel_a_ms:.2f}x kernel A's {kernel_a_ms:.3f}; bound "
                f"{b_ms:.3f} ms by {by}; plain {plain:.3f} ms; cuDNN "
                f"nn.LSTM({f}, {HIDDEN}) {lib:.3f} ms) on {card}")
            log(f"  plan: {_staged_plan_line(plan)}")
    log(f"kernel F registers: {_registers_line(registers, 'F')}")
    del x, hoisted, y1, y2, x_bf

    # under grad at the training shape: LSTMLayerScan = kernels C and D
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    xg = torch.randn(TRAIN_T, TRAIN_ROWS, SB_FEATURES, generator=gen, device=dev)
    gout = torch.randn(TRAIN_T, TRAIN_ROWS, HIDDEN, generator=gen,
                       device=dev).to(torch.bfloat16)
    kernel_in = [t.clone().requires_grad_() for t in (xg, *weights[0])]
    before = dict(L.launch_counts)
    (L.lstm_layer_tm(*kernel_in, False, torch.float32)
     * gout.float()).sum().backward()
    torch.cuda.synchronize()
    launched = {k: L.launch_counts[k] - before[k] for k in before}
    c_entry = routed("lstm_scan_fwd_train", TRAIN_ROWS)
    d_entry = routed("lstm_scan_bwd", TRAIN_ROWS)
    check(launched == {**dict.fromkeys(launched, 0), c_entry: 1, d_entry: 1},
          f"LSTMLayerScan launched 1 {c_entry} and 1 {d_entry} and nothing "
          f"else (got {launched})")
    exact_in = [t.clone().requires_grad_() for t in (xg, *weights[0])]
    (L.lstm_layer_reference_tm(*exact_in, compute_dtype=torch.float32)
     * gout.float()).sum().backward()
    torch.cuda.synchronize()
    got, want = [t.grad for t in kernel_in], [t.grad for t in exact_in]
    check(all(g.dtype == torch.float32 for g in got),
          "LSTMLayerScan gradient dtypes")
    err_x = (got[0] - want[0]).abs()
    peak = want[0].abs().max().item()
    rel = [_rel_norm(g, w) for g, w in zip(got[1:], want[1:])]
    log(f"LSTMLayerScan T={TRAIN_T} rows={TRAIN_ROWS} F={SB_FEATURES} vs "
        f"float32 autograd: dx max|err|/peak {err_x.max().item() / peak:.3e} "
        f"mean/peak {err_x.mean().item() / peak:.3e}; |err|/|grad| dW_ih "
        f"{rel[0]:.3e}, dW_hh {rel[1]:.3e}, db {rel[2]:.3e}")
    check(err_x.max().item() < GRAD_MAX_REL * peak
          and err_x.mean().item() < DX_MEAN_REL * peak
          and max(rel) < GRAD_DW_REL,
          f"LSTMLayerScan gradients vs float32 within {GRAD_MAX_REL}/"
          f"{DX_MEAN_REL}/{GRAD_DW_REL}")
    # two faulty dx the limits must reject: dgates without the forget
    # gate's derivative (diffuse), and one step's dx lost (local)
    w_ih, w_hh, bias = (w.detach() for w in kernel_in[1:])
    bf16, hsz = torch.bfloat16, HIDDEN
    with torch.no_grad():
        # as LSTMLayerScan's forward: bf16 operands, fp32 sums, then bf16
        gates = (xg.to(bf16).float() @ w_ih.to(bf16).float() + bias).to(bf16)
        dgates = L.lstm_scan_bwd_tm(gates, *L.lstm_scan_train_tm(gates, w_hh),
                                    gout, w_hh)
        dgates[..., hsz:2 * hsz] = 0
        dx_f = dgates.float() @ w_ih.to(bf16).float().t()
        fault_f = (dx_f - want[0]).abs().mean().item() / peak
        dx_step = got[0].clone()
        dx_step[TRAIN_T // 2] = 0
        fault_step = (dx_step - want[0]).abs()
    log(f"faulty dx: forget-gate derivative left out, mean/peak "
        f"{fault_f:.3e}; step {TRAIN_T // 2} lost, max/peak "
        f"{fault_step.max().item() / peak:.3e} mean/peak "
        f"{fault_step.mean().item() / peak:.3e}")
    check(fault_f > DX_MEAN_REL and fault_step.max().item() > GRAD_MAX_REL * peak,
          f"the dx limits {GRAD_MAX_REL}/{DX_MEAN_REL} reject both faulty dx")
    del gates, dgates, dx_f, dx_step, fault_step
    log(f"lstm_layer_fwd launches on its path (two layers): "
        f"{launches['lstm_layer_fwd']}")
    return (dict(max_abs_err=max_err, **times["layer 1"],
                 layer_2=times["layer 2"]), launches["lstm_layer_fwd"],
            dict(max_abs_err=max_err_blk, **block_times["layer 1"],
                 layer_2=block_times["layer 2"]))


# Kernel D's cluster instances as ptxas reported them on an H100 before kernel
# G had a cluster: kernel G lives in a source of its own so that they stay.
KERNEL_D_REGISTERS = {"D cluster, slice resident": "120 registers, 0/0 B spilled",
                   "D cluster, slice streamed": "128 registers, 16/32 B spilled"}


def _chains_plan_line(plan):
    """A launch plan of kernel G (a ChainsPlan)."""
    if plan.design == "block":
        return (f"single block of {plan.rows} rows ({plan.chains} chains), "
                f"{plan.clusters} blocks, {plan.active} at once, "
                f"{plan.waves} wave(s), {plan.smem_bytes} B")
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, {plan.chains} "
            f"chains of {'row tiles' if plan.arrangement == 0 else 'units'} "
            f"a warp, W_hh^T slice {'resident' if plan.resident else 'from L2'}"
            f", {plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B a CTA, "
            f"modelled {plan.step_us:.2f} us a step")


def phase_lstm_chains(dev, library_bwd_ms, registers):
    """Row 9: the chains backward (kernel G) through scripts.perf_lstm_chains
    with 2 and 4 chains, bit for bit against kernel D at the script's shape,
    the training shape and a ragged row count (H=384; kernel G's cluster)
    and at H=100, 200 (its single block) and 512 (its cluster); against its
    plain version; its times beside kernel D's in alternating rounds, with
    µs a step a wave, its plans and registers, and kernel D's cluster
    registers against their recorded counts; its single block (its first
    design, now with dc in registers) timed at the training shape. Returns the two entries' numbers
    and their launches on this path."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_lstm_chains as PC
    shapes = [(PC.T, PC.B, HIDDEN), (TRAIN_T, TRAIN_ROWS, HIDDEN),
              (TRAIN_T, TRAIN_RAGGED_ROWS, HIDDEN)]
    shapes += [(T_CHUNK, 40, h) for h in (*PADDED_HIDDEN, FB_HIDDEN)]
    expected = dict.fromkeys(("lstm_scan_bwd_chains",
                              "lstm_scan_bwd_chains_block"), 0)
    L.reset_launch_counts()
    for i, (t_len, rows, h) in enumerate(shapes):
        inputs = PC.make_inputs(t_len, rows, h, dev, seed=SEED + 14 + i)
        want = L.lstm_scan_bwd_tm(*inputs)           # kernel D, to compare
        for n in L.CHAIN_COUNTS:
            got = PC.chains_bwd(*inputs, n_chains=n)     # the path
            torch.cuda.synchronize()
            plan = L.card_chains_scan_plan(dev, -(-h // 16) * 16, rows, n)
            expected["lstm_scan_bwd_chains" + (
                "_block" if plan.design == "block" else "")] += 1
            check(torch.equal(got, want), f"kernel G ({n} chains) == "
                  f"lstm_scan_bwd bitwise (T={t_len} rows={rows} H={h})")
            log(f"kernel G, {n} chains, T={t_len} rows={rows} H={h}: == "
                f"lstm_scan_bwd over all {got.numel()} outputs; "
                f"{_chains_plan_line(plan)}")
        del inputs, got, want
    launches = {k: L.launch_counts[k] for k in expected}
    log(f"kernel G's launches on its path: {launches}")
    check(launches == expected, f"kernel G launched once a shape and chain "
          f"count, by its plan's design (expected {expected})")
    for n in L.CHAIN_COUNTS:       # above H=512 no design holds the chains
        try:
            L.plan_chains_scan(640, TRAIN_ROWS, n, lambda *a: 1)
            check(False, f"kernel G ({n} chains) has no route at H=640")
        except ValueError as e:
            log(f"above H=512 kernel G refuses, as ROADMAP.md logs: {e}")

    # at the training shape: the plain version, and D against G in turns
    card = card_line()
    inputs = PC.make_inputs(TRAIN_T, TRAIN_ROWS, HIDDEN, dev, seed=SEED + 15)
    want = PC.chains_bwd_reference(*inputs)
    peak = want.float().abs().max().item()
    max_err = {}
    for n in L.CHAIN_COUNTS:
        err = (PC.chains_bwd(*inputs, n_chains=n).float() - want.float()).abs()
        max_err[n] = err.max().item()
        log(f"kernel G ({n} chains) T={TRAIN_T} rows={TRAIN_ROWS} vs plain: "
            f"max|err| {max_err[n]:.3e} mean {err.mean().item():.3e} (peak "
            f"|dgates| {peak:.3f})")
        check(max_err[n] < BWD_MAX_REL * peak
              and err.mean().item() < BWD_MEAN_REL * peak,
              f"kernel G ({n} chains) vs plain within {BWD_MAX_REL}/"
              f"{BWD_MEAN_REL} of the peak")
        del err
    # kernel G's first design, kept as its single block: same bits, timed
    block = L.plan_chains_scan(HIDDEN, TRAIN_ROWS, 2, lambda *a: 0)
    got = L.lstm_scan_bwd_planned_tm(*inputs, block)
    err_blk = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, PC.chains_bwd(*inputs)),
          "kernel G's single block == its cluster bitwise (2 chains)")
    del got, want
    ms_blk = cuda_ms(lambda: L.lstm_scan_bwd_planned_tm(*inputs, block),
                     iters=2)
    times = PC.ab(inputs)          # best of 10 in 3 alternating rounds
    best = {k: min(v) for k, v in times.items()}
    plain = cuda_ms(lambda: PC.chains_bwd_reference(*inputs), iters=2)
    b_ms, by = bound(TRAIN_T, TRAIN_ROWS, HIDDEN, streams=11, products=2)
    plans = {n: L.card_chains_scan_plan(dev, HIDDEN, TRAIN_ROWS, n)
             for n in L.CHAIN_COUNTS}
    d_plan = L.card_bwd_scan_plan(dev, HIDDEN, TRAIN_ROWS)
    step = {k: 1e3 * best[k] / TRAIN_T / p.waves for k, p in (
        ("lstm_scan_bwd", d_plan), *((f"chains{n}", plans[n])
                                     for n in L.CHAIN_COUNTS))}
    log(f"kernel G at T={TRAIN_T} rows={TRAIN_ROWS} H={HIDDEN}: 2 chains "
        f"{best['chains2']:.3f} ms ({step['chains2']:.2f} us a step a wave), "
        f"4 chains {best['chains4']:.3f} ms ({step['chains4']:.2f}); kernel D "
        f"{best['lstm_scan_bwd']:.3f} ms ({step['lstm_scan_bwd']:.2f}) in the "
        f"same rounds ({'; '.join(k + ' ' + ' '.join(f'{t:.3f}' for t in r) for k, r in times.items())}); "
        f"bound {b_ms:.3f} ms by {by}; plain {plain:.3f} ms; cuDNN backward "
        f"{library_bwd_ms:.3f} ms; the single block (the first design, 2 chains) "
        f"{ms_blk:.3f} ms on {card}")
    for n, plan in plans.items():
        log(f"  {n} chains: {_chains_plan_line(plan)}")
    log(f"  kernel G registers: {_registers_line(registers, 'G')}")
    d_regs = {k: v for k, v in registers.items() if k.startswith("D cluster")}
    log(f"  kernel D's cluster registers {d_regs or 'not rebuilt in this run'}"
        f" (recorded: {KERNEL_D_REGISTERS}; unchanged: "
        f"{d_regs == KERNEL_D_REGISTERS if d_regs else 'not known'})")
    del inputs
    inputs = PC.make_inputs(PC.T, PC.B, HIDDEN, dev, seed=SEED + 14)
    script = {k: min(v) for k, v in PC.ab(inputs).items()}
    log(f"at the script's shape T={PC.T} rows={PC.B}: best D "
        f"{script['lstm_scan_bwd']:.3f} ms, G 2 chains {script['chains2']:.3f}"
        f" ms, 4 chains {script['chains4']:.3f} ms (bound "
        f"{bound(PC.T, PC.B, HIDDEN, streams=11, products=2)[0]:.3f} ms) on "
        f"{card}")
    del inputs
    kernels = {
        "lstm_scan_bwd_chains": dict(
            max_abs_err=max(max_err.values()), ms=best["chains2"],
            plain_ms=plain, bound_ms=b_ms, bound_by=by,
            library_ms=library_bwd_ms, chains4_ms=best["chains4"],
            kernel_d_ms=best["lstm_scan_bwd"], us_step_wave=step,
            script_shape_ms=script,
            plan={n: dataclasses.asdict(p) for n, p in plans.items()}),
        "lstm_scan_bwd_chains_block": dict(
            max_abs_err=err_blk, ms=ms_blk, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=library_bwd_ms)}
    return kernels, launches


def _staged_plan_line(plan):
    """A launch plan of kernel E or F (a ScanPlan)."""
    return (f"cluster C={plan.cluster} x R={plan.rows} rows, "
            f"{plan.clusters} clusters, cudaOccupancyMaxActiveClusters "
            f"{plan.active}, {plan.waves} wave(s), {plan.smem_bytes} B of "
            f"shared memory a CTA")


def phase_lstm_unroll(dev, registers):
    """Row 10: the K-step unrolled forward through scripts.perf_lstm_unroll,
    bit for bit against kernel A (at the script's and the serving row
    counts, and at H=100 and 200, which the wrapper pads) and, at H=640 and
    768, which no cluster holds, its single block (within
    single_block_forwards(): the route there is the streamed cluster, phase
    25) against kernel A's route there (the streamed cluster); against its
    plain version, and its times beside kernel A's (the single block's at
    H=768 beside lstm_scan_fwd_block), with its plans and registers.
    Returns both entries' numbers and their launches on this path."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.scripts import perf_lstm_unroll as PU
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    w_hh = _uniform(gen, dev, (HIDDEN, 4 * HIDDEN), HIDDEN ** -0.5)
    shapes = [(HIDDEN, T_FRAMES, rows) for rows in (TRAIN_ROWS, ROWS)]
    shapes += [(h, T_CHUNK, ROWS) for h in PADDED_HIDDEN]
    # H no cluster holds: kernel E's single block against lstm_scan_fwd_block
    shapes += [(h, T_CHUNK, 40) for h in BLOCK_HIDDEN]
    expected = dict.fromkeys(("lstm_scan_fwd_unrolled",
                              "lstm_scan_fwd_unrolled_block"), 0)
    L.reset_launch_counts()
    with torch.no_grad():
        for h, t_len, rows in shapes:
            w = w_hh if h == HIDDEN else _uniform(gen, dev, (h, 4 * h),
                                                  h ** -0.5)
            gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                                device=dev).to(torch.bfloat16)
            for k in L.UNROLL_STEPS:
                with (L.single_block_forwards() if h in BLOCK_HIDDEN
                      else contextlib.nullcontext()):
                    got = PU.lstm_unrolled(gates, w, block_t=k)  # the path
                    hp, route, _ = L.unrolled_route(h, k)
                want = L.lstm_scan_tm(gates, w)                  # kernel A
                torch.cuda.synchronize()
                expected["lstm_scan_fwd_unrolled" + route] += 1
                a_entry = "lstm_scan_fwd" + L._forward_route(h, rows,
                                                             dev)[1]
                check(torch.equal(got, want), f"lstm_scan_fwd_unrolled{route} "
                      f"K={k} == {a_entry} bitwise (H={h} rows={rows})")
                where = (f"single block of {L.unrolled_block_rows(hp, k)} "
                         f"rows, {L.unrolled_block_smem_bytes(hp, L.unrolled_block_rows(hp, k), k)} B"
                         if route else _staged_plan_line(
                             L.card_unrolled_plan(dev, hp, rows, k)))
                log(f"lstm_scan_fwd_unrolled{route} K={k} H={h} T={t_len} "
                    f"rows={rows}: == {a_entry} over all {got.numel()} "
                    f"outputs; {hp} units, {where}")
            del gates, got, want
        launches = {k: L.launch_counts[k] for k in expected}
        log(f"kernel E's launches on its path: {launches}")
        check(launches == expected,
              f"kernel E launched once a shape and K, by its route "
              f"(expected {expected})")
        log(f"kernel E registers: {_registers_line(registers, 'E')}; "
            f"kernels A-C: {_registers_line(registers, 'ABC')}")

        # the single block at H=768, the full-band training shape's rows and
        # its T cut to whole groups of 4 steps, beside lstm_scan_fwd_block
        h, t_len, rows = BLOCK_HIDDEN[-1], TRAIN_T - TRAIN_T % 4, TRAIN_BATCH
        w = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
        gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                            device=dev).to(torch.bfloat16)
        with L.single_block_forwards():
            got = PU.lstm_unrolled(gates, w)
        want = PU.lstm_unrolled_reference(gates, w)
        err_blk = (got.float() - want.float()).abs()
        check(err_blk.max().item() < KERNEL_MAX_ABS
              and err_blk.mean().item() < KERNEL_MEAN_ABS,
              f"lstm_scan_fwd_unrolled_block vs plain at H={h}")
        err_blk = err_blk.max().item()
        with L.single_block_forwards():
            ms_blk = {k: cuda_ms(lambda k=k: PU.lstm_unrolled(gates, w,
                                                              block_t=k),
                                 iters=5) for k in L.UNROLL_STEPS}
            ms_a_blk = cuda_ms(lambda: L.lstm_scan_tm(gates, w), iters=5)
        plain_blk = cuda_ms(lambda: PU.lstm_unrolled_reference(gates, w),
                            iters=2)
        lib_blk = library_lstm_ms(gates, w)
        b_blk, by_blk = bound(t_len, rows, h)
        log(f"lstm_scan_fwd_unrolled_block at T={t_len} rows={rows} H={h}: "
            f"K=2 {ms_blk[2]:.3f} ms ({L.unrolled_block_rows(h, 2)} rows a "
            f"block), K=4 {ms_blk[4]:.3f} ms ({L.unrolled_block_rows(h, 4)} "
            f"rows); lstm_scan_fwd_block {ms_a_blk:.3f} ms; max|err| "
            f"{err_blk:.3e}; bound {b_blk:.4f} ms by {by_blk}; plain "
            f"{plain_blk:.3f} ms; cuDNN LSTM {lib_blk:.3f} ms on {card_line()}")
        del gates, got, want

        # at T=628 x 2304 rows, the script's shape
        rows = TRAIN_ROWS
        gates = torch.randn(T_FRAMES, rows, 4 * HIDDEN, generator=gen,
                            device=dev).to(torch.bfloat16)
        got = PU.lstm_unrolled(gates, w_hh)
        want = PU.lstm_unrolled_reference(gates, w_hh)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = err.max().item()
        log(f"lstm_scan_fwd_unrolled K=2 T={T_FRAMES} rows={rows} vs plain, "
            f"bf16 out: max|err| {max_err:.3e} mean {err.mean().item():.3e}")
        # bf16 outputs: a difference that crosses a rounding boundary shows
        # as one bf16 step of |h| < 1, 3.9e-3 at most (measured 3.9e-3 max,
        # 2.1e-6 mean)
        check(max_err < KERNEL_MAX_ABS and err.mean().item() < KERNEL_MEAN_ABS,
              f"lstm_scan_fwd_unrolled vs plain within {KERNEL_MAX_ABS}/"
              f"{KERNEL_MEAN_ABS}")
        del got, want, err
        # the script's A/B: best of 8 in 3 rounds of alternating order
        times = PU.ab(gates, w_hh)
        ms = {k: min(rounds) for k, rounds in times.items()}
        plain = cuda_ms(lambda: PU.lstm_unrolled_reference(gates, w_hh), iters=2)
        lib = library_lstm_ms(gates, w_hh)
    b_ms, by = bound(T_FRAMES, rows, HIDDEN)
    plans = {k: L.card_unrolled_plan(dev, L.unrolled_hidden(HIDDEN, k), rows,
                                     k) for k in L.UNROLL_STEPS}
    log(f"lstm_scan_fwd_unrolled at T={T_FRAMES} rows={rows} H={HIDDEN}: K=2 "
        f"{ms[2]:.3f} ms, K=4 {ms[4]:.3f} ms; lstm_scan_fwd (K=1) {ms[1]:.3f} "
        f"ms (rounds {'; '.join(f'K={k} ' + ' '.join(f'{t:.3f}' for t in r) for k, r in times.items())}); "
        f"bound {b_ms:.3f} ms by {by}; plain {plain:.3f} ms; cuDNN LSTM "
        f"{lib:.3f} ms on {card_line()}")
    for k, plan in plans.items():
        log(f"  K={k}: {_staged_plan_line(plan)}, modelled "
            f"{L.unrolled_step_us(L.unrolled_hidden(HIDDEN, k), plan.cluster, plan.rows):.2f} us a "
            f"step; measured {1e3 * ms[k] / T_FRAMES / plan.waves:.2f} us a "
            f"step a wave")
    return ({"lstm_scan_fwd_unrolled": dict(
                max_abs_err=max_err, ms=ms[2], plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=lib, kernel_a_ms=ms[1], k4_ms=ms[4],
                plan=dataclasses.asdict(plans[2])),
             "lstm_scan_fwd_unrolled_block": dict(
                max_abs_err=err_blk, ms=ms_blk[2], plain_ms=plain_blk,
                bound_ms=b_blk, bound_by=by_blk, library_ms=lib_blk,
                k4_ms=ms_blk[4], lstm_scan_fwd_block_ms=ms_a_blk)},
            launches)


@dataclasses.dataclass
class ModelPath:
    """One model of the port driven end to end: how to build it, which
    Inferencer mode and trainer model_type it takes, and which kernels a
    forward and a training step must launch."""
    name: str
    model_cls: type
    config: object
    sd: dict                    # state dict carried across from the JAX layout
    mode: str                   # Inferencer mode
    n_inputs: int               # leading outputs of the front end the model takes
    fwd: str                    # kernel entry of an unchunked forward
    carry: str                  # kernel entry of a chunked forward
    per_forward: int            # fwd launches, unchunked
    per_long_forward: int       # fwd launches on the chunked 30 s clip
    train_config: Callable      # compute_dtype -> EnhanceTrainConfig
    per_step: dict              # launches per training step
    # of per_forward, the full band's (H=FB_HIDDEN over one row a clip);
    # the rest and per_long_forward's are the sub-band's
    fb_forward: int = 0

    def model(self, dtype, device, gates_bytes_limit=None):
        m = self.model_cls(self.config, compute_dtype=dtype, device=device,
                           gates_bytes_limit=gates_bytes_limit)
        m.load_state_dict(self.sd)
        return m

    def inferencer(self, model, device):
        from generative_audio_torch.eval import Inferencer, InferencerConfig
        return Inferencer(model, InferencerConfig(inference_type=self.mode),
                          device=device)


def model_paths():
    """FullSubNet+ and FullSubNet v1 (GRU, and LSTM for one reference clip)
    at full width, with random weights made with numpy from SEED in the JAX
    param layout and carried across by utils/convert.py. The v1 models serve
    with drop_band off (a batch's mask must cover the spectrum) and train
    with the default two groups."""
    from generative_audio_torch import models as M
    from generative_audio_torch.train import EnhanceTrainConfig
    from generative_audio_torch.utils import convert
    plus_cfg = M.FullSubNetPlusConfig()
    plus = ModelPath(
        name="FullSubNet+", model_cls=M.FullSubNetPlus, config=plus_cfg,
        sd=convert.convert_fullsubnet_plus(
            convert.random_fullsubnet_plus_params(plus_cfg, seed=SEED)),
        mode="mag_complex_full_band_crm_mask", n_inputs=3,
        fwd="lstm_scan_fwd", carry="lstm_scan_fwd_carry",
        per_forward=2, per_long_forward=0,
        train_config=lambda dtype: EnhanceTrainConfig(
            model=M.FullSubNetPlusConfig(num_groups_in_drop_band=2),
            compute_dtype=dtype),
        per_step={"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2})
    v1 = {}
    for kind in ("GRU", "LSTM"):
        cfg = M.FullSubNetConfig(sequence_model=kind, num_groups_in_drop_band=1)
        family = kind.lower()
        v1[kind] = ModelPath(
            name=f"FullSubNet v1-{kind}", model_cls=M.FullSubNet, config=cfg,
            sd=convert.convert_fullsubnet(
                convert.random_fullsubnet_params(cfg, seed=SEED + 11), kind),
            mode="full_band_crm_mask", n_inputs=1,
            fwd=f"{family}_scan_fwd", carry=f"{family}_scan_fwd_carry",
            # at 30 s the full-band model stays unchunked
            per_forward=4, per_long_forward=2, fb_forward=2,
            train_config=lambda dtype, kind=kind: EnhanceTrainConfig(
                model_type="fullsubnet",
                model_v1=M.FullSubNetConfig(sequence_model=kind),
                compute_dtype=dtype),
            per_step={"gru_scan_fwd": 4, "gru_scan_bwd": 4,
                      "gru_scan_bwd_dwhh": 4} if kind == "GRU" else
            {"lstm_scan_fwd_train": 4, "lstm_scan_bwd": 4})
    return plus, v1["GRU"], v1["LSTM"]


class _Fed(torch.nn.Module):
    """A model that takes its inputs through `streams` first."""

    def __init__(self, model, streams):
        super().__init__()
        self.model, self.streams = model, streams

    def forward(self, *inputs):
        return self.model(*self.streams(*inputs))


def phase_reference(dev, path, model, streams=None):
    """A 1 s clip: the bf16 model on the card against the float32 model on
    the CPU (the algorithm as the CPU tests hold it against JAX), on the
    model's inputs and wav to wav through the Inferencer. With `streams`,
    both models take their inputs through it (_Fed)."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    ref = path.model(torch.float32, "cpu")
    what = path.name
    if streams is not None:
        model, ref = _Fed(model, streams), _Fed(ref, streams)
        what += f" fed {streams.__name__}"
    wav = np.random.default_rng(SEED + 1).standard_normal(16000).astype(
        np.float32) * 0.1
    inputs = prepare_input_from_waveform(torch.from_numpy(wav)[None], 512, 256,
                                         512)[:path.n_inputs]
    with torch.inference_mode():
        want = ref(*inputs)
        got = model(*(x.to(dev) for x in inputs)).float().cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"reference {what}: 1 s clip, bf16 cRM on the card vs float32 on "
        f"the CPU: max|err|/peak {rel:.3e} (peak {want.abs().max().item():.3f})")
    check(torch.isfinite(got).all().item() and rel < PATH_REL,
          f"{what}: bf16 model vs float32 reference within {PATH_REL}")
    out_gpu = path.inferencer(model, dev).enhance(wav)
    out_cpu = path.inferencer(ref, "cpu").enhance(wav)
    rel_wav = np.abs(out_gpu - out_cpu).max() / np.abs(out_cpu).max()
    log(f"reference {what}: 1 s clip wav to wav, card vs CPU: "
        f"max|err|/peak {rel_wav:.3e}")
    check(rel_wav < PATH_REL,
          f"{what}: wav vs float32 reference within {PATH_REL}")


def forward_counts(path, clips, n=1):
    """{entry: launches} of n unchunked forwards of `path` over `clips`
    clips: the sub-band model's over 257 rows a clip, the full band's (its
    fb_forward launches, H=FB_HIDDEN) over one row a clip, each named as
    the route takes it."""
    return routed_counts(
        (path.fwd, clips * ROWS // 8, n * (path.per_forward - path.fb_forward)),
        (path.fwd, clips, n * path.fb_forward, False, FB_HIDDEN))


def _counts_hold(counts, before, expected):
    return all(counts[k] - before[k] == n for k, n in expected.items())


def phase_serving(dev, path, model, counts):
    inf = path.inferencer(model, dev)
    rng = np.random.default_rng(SEED + 2)
    card = card_line()
    expected = forward_counts(path, 1)      # a clip's 257 sub-band rows
    for seconds in (3.0, 7.5, 10.0):
        noisy = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
        before = dict(counts)
        t0 = time.perf_counter()
        out = inf.enhance(noisy)
        wall = (time.perf_counter() - t0) * 1e3
        check(out.shape == noisy.shape and np.isfinite(out).all(),
              f"{path.name} {seconds} s request: shape and finite")
        check(_counts_hold(counts, before, expected),
              f"{expected} (the route's) launched per forward (got "
              f"{_launched(counts, before)})")
        log(f"serve {path.name} {seconds} s clip: rtf {inf.last_rtf:.5f}, "
            f"{wall:.2f} ms per call on {card}")

    clips = [((rng.standard_normal(160000) * 0.1).astype(np.float32), f"clip{i}")
             for i in range(8)]
    expected = forward_counts(path, 8, 2)   # the batch's 8 x 257 rows
    before = dict(counts)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        inf.enhance_dir(clips, out_dir, log=lambda *_: None, batch_size=8)
        wall = (time.perf_counter() - t0) * 1e3
        from generative_audio_torch.data import read_wav
        for noisy, name in clips:
            sr, got = read_wav(Path(out_dir) / f"{name}.wav")
            check(sr == 16000 and got.shape == noisy.shape
                  and np.isfinite(got).all(), f"enhance_dir output {name}")
    # the bucket is warmed once at its batch outside the timed window
    check(_counts_hold(counts, before, expected),
          f"{expected} (the route's) launched for the two batched forwards "
          f"(warm-up and request; got {_launched(counts, before)})")
    log(f"serve {path.name} enhance_dir 8 x 10 s, batch 8: rtf "
        f"{inf.last_rtf:.5f}, {wall:.2f} ms on {card}")
    return inf.last_rtf


def phase_long_clip(dev, path, model, counts):
    limit = LONG_CLIP_GATES_LIMIT
    chunked_model = path.model(torch.bfloat16, dev, gates_bytes_limit=limit)
    noisy = (np.random.default_rng(SEED + 3).standard_normal(30 * 16000)
             * 0.1).astype(np.float32)
    whole = path.inferencer(model, dev).enhance(noisy)
    before = dict(counts)
    inf = path.inferencer(chunked_model, dev)
    out = inf.enhance(noisy)
    # the sub-band model in chunks; the full band's forwards unchunked
    fwd = (routed(path.fwd, 1, False, FB_HIDDEN) if path.fb_forward
           else routed(path.fwd, ROWS // 8))
    carry = routed(path.carry, ROWS // 8)
    launched_c = counts[carry] - before[carry]
    check(launched_c > 0
          and counts[fwd] - before[fwd] == path.per_long_forward,
          f"{path.name}: the 30 s request took the chunked path "
          f"({carry}, the route's, and {path.per_long_forward} {fwd})")
    rel = np.abs(out - whole).max() / np.abs(whole).max()
    log(f"long clip {path.name} 30 s, gates limit {limit >> 20} MiB: "
        f"{carry} launched {launched_c} times, rtf {inf.last_rtf:.5f}; "
        f"chunked vs unchunked max|err|/peak {rel:.3e}")
    check(out.shape == noisy.shape and np.isfinite(out).all() and rel < PATH_REL,
          f"{path.name}: chunked vs unchunked within {PATH_REL}")


def _noise_batch(seed, batch, samples):
    """(noisy, clean) float32 [batch, samples]: seeded noise as the clean
    signal, plus seeded noise."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((batch, samples)) * 0.03
                     ).astype(np.float32)
    return noisy, clean


def _first_grads(named, what):
    """Hooks on `named` (name, parameter) pairs that record whether each
    gradient arrives finite and not all zero. Returns a function to call
    after the first step: it removes the hooks and fails unless every
    tensor got such a gradient."""
    named = list(named)
    flags, names = [], []

    def arrived(name):
        def hook(param):
            names.append(name)
            flags.append(torch.isfinite(param.grad).all()
                         & (param.grad != 0).any())
        return hook

    hooks = [p.register_post_accumulate_grad_hook(arrived(k))
             for k, p in named]

    def verify():
        for hook in hooks:
            hook.remove()
        ok = torch.stack(flags).cpu().tolist()
        bad = [k for k, good in zip(names, ok) if not good]
        check(len(ok) == len(named) and not bad,
              f"every {what} tensor got a finite non-zero gradient in step 1 "
              f"({len(ok)} of {len(named)} arrived; failing: {bad[:5]})")
    return verify


def phase_training(dev, path, counts):
    """Five steps of EnhanceTrainer at full width on one fixed batch. The
    caller has set the launch counts to 0."""
    from generative_audio_torch.train import EnhanceTrainer
    cfg = path.train_config("bfloat16")
    trainer = EnhanceTrainer(cfg, seed=SEED, pretrained_state_dict=path.sd,
                             device=dev)
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    verify_grads = _first_grads(trainer.state.model.named_parameters(),
                                "parameter")
    torch.cuda.reset_peak_memory_stats(dev)
    per_step = routed_step(path.per_step)
    expected = {**dict.fromkeys(counts, 0), **per_step}
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch([(noisy, clean)]))   # ends in a fetch
        times.append((time.perf_counter() - t0) * 1e3)
        launched = {k: counts[k] - before[k] for k in counts}
        check(launched == expected,
              f"{path.name} train step {step + 1} launched {per_step} "
              f"and nothing else (got {launched})")
        if step == 0:
            verify_grads()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"train {path.name}: batch {TRAIN_BATCH} x {TRAIN_SAMPLES / 16000:.3f} "
        f"s, bf16, losses {' '.join(f'{x:.5f}' for x in losses)}")
    check(np.isfinite(losses).all(), "training losses finite")
    check(losses[-1] < losses[0], "the fifth loss is below the first")
    check(trainer.state.step == TRAIN_STEPS, "five optimizer steps counted")
    steady = statistics.median(times[1:])
    STEP_MS[path.name] = steady
    log(f"train {path.name}: ms per step {' '.join(f'{x:.1f}' for x in times)}; "
        f"median of steps 2-{TRAIN_STEPS} {steady:.2f} ms = "
        f"{TRAIN_BATCH / steady * 1e3:.2f} clips/s; peak memory {peak:.2f} GiB "
        f"on {card_line()}")
    return trainer


def phase_training_reference(dev, path, dtype="bfloat16"):
    """A batch of 4 x 1 s: the loss and gradients on the card in `dtype`
    (bf16, or float32 on the recurrent layers' mixed route) against the
    float32 model on the CPU."""
    import torch.nn.functional as F
    from generative_audio_torch.train import (
        enhance_loss_fn, init_enhance_state)
    noisy, clean = (torch.from_numpy(x) for x in
                    _noise_batch(SEED + 7, 4, 16000))
    grads, losses = {}, {}
    mode = "bf16" if dtype == "bfloat16" else "float32 (mixed)"
    for name, device, dtype in (("card", dev, dtype),
                                ("cpu", "cpu", "float32")):
        cfg = path.train_config(dtype)
        state = init_enhance_state(cfg, SEED, device)
        state.model.load_state_dict(path.sd)
        loss = enhance_loss_fn(state.model, noisy.to(device), clean.to(device),
                               cfg)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {k: p.grad.float().cpu()
                       for k, p in state.model.named_parameters()}
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    top = max(g.norm().item() for g in grads["cpu"].values())
    rows = []
    for k, want in grads["cpu"].items():
        got = grads["card"][k]
        cos = F.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
        rows.append((cos, got.norm().item() / max(want.norm().item(), 1e-30),
                     want.norm().item() / top, k))
    carrying = [r for r in rows if r[2] > 1e-3]
    worst = min(carrying)
    log(f"train reference {path.name}: 4 x 1 s, {mode} on the card vs float32 "
        f"on the CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f} (rel "
        f"{rel:.3e}); of {len(rows)} parameter tensors {len(carrying)} carry "
        f"the gradient (norm above 1e-3 of the largest): lowest cosine "
        f"{worst[0]:.4f} ({worst[3]}), norm ratios "
        f"{min(r[1] for r in carrying):.3f}-{max(r[1] for r in carrying):.3f}")
    for cos, ratio, share, k in rows:
        if ".sequence_model.weight_ih" in k or ".sequence_model.bias" in k \
                or ".sequence_model.weight_hh" in k:
            log(f"  {k}: cosine {cos:.5f}, norm ratio {ratio:.4f}, "
                f"norm/largest {share:.2e}")
    check(rel < TRAIN_LOSS_REL,
          f"{mode} loss vs float32 within {TRAIN_LOSS_REL}")
    check(worst[0] > TRAIN_GRAD_COS
          and all(abs(r[1] - 1) < TRAIN_GRAD_RATIO for r in carrying),
          f"{mode} gradients vs float32: cosine above {TRAIN_GRAD_COS}, "
          f"norms within {TRAIN_GRAD_RATIO}")


def _profile(fn, what):
    """torch.profiler's device time by kernel for one call of fn, against
    its wall time. A user annotation's range on the device timeline (the
    optimizer's "Optimizer.step#Adam.step") spans kernels and the gaps
    between them, so it is left out of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(ms for _, ms, _ in rows)
    check(busy > 0, f"torch.profiler recorded device time for {what}")
    log(f"profile: {what}, wall {wall:.2f} ms (profiled), "
        f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), on {card_line()}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")
    return wall, busy, rows


def phase_profile(dev, path, model, trainer):
    """Where the time goes on the card, by kernel: one batch-8 x 10 s model
    forward and one training step. Run after the launch counts are read."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wav = torch.randn(8, 160000, generator=gen, device=dev) * 0.1
    inputs = prepare_input_from_waveform(wav, 512, 256, 512)[:path.n_inputs]
    with torch.inference_mode():
        _profile(lambda: model(*inputs), f"{path.name} batch 8 x 10 s forward")
    del inputs, wav
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    _profile(lambda: trainer.train_epoch([(noisy, clean)]),
             f"{path.name} training step, batch {TRAIN_BATCH} x "
             f"{TRAIN_SAMPLES / 16000:.3f} s")


def drive(dev, path, kernels_of_path):
    """One model's main path: the serving entry point (single requests, a
    batch, a long clip), then the training entry point, each with the launch
    counts set to 0 just before and read just after. Returns the launches of
    the path's kernels, serving plus training, and the batched RTF."""
    from generative_audio_torch.ops import lstm as L
    model = path.model(torch.bfloat16, dev)
    phase_reference(dev, path, model)

    L.reset_launch_counts()
    batched_rtf = phase_serving(dev, path, model, L.launch_counts)
    phase_long_clip(dev, path, model, L.launch_counts)
    serving = dict(L.launch_counts)
    log(f"launches on the serving path of {path.name}: {serving}")

    L.reset_launch_counts()
    trainer = phase_training(dev, path, L.launch_counts)
    training = dict(L.launch_counts)
    log(f"launches on the training path of {path.name}: {training}")
    for name, per_step in routed_step(path.per_step).items():
        check(training[name] == per_step * TRAIN_STEPS,
              f"{name} launched {per_step} times per step on the training path")
    launched = {k: serving[k] + training[k] for k in serving}
    for name in launched:
        if name in kernels_of_path:
            check(launched[name] > 0, f"{name} launched on {path.name}'s path")
        else:
            check(launched[name] == 0,
                  f"{name} is not on {path.name}'s path (got {launched[name]})")
    phase_training_reference(dev, path)
    phase_profile(dev, path, model, trainer)
    return {k: launched[k] for k in kernels_of_path}, batched_rtf


# Phase 13: the rest of serving at FullSubNet+'s full width.
CHUNK_SECONDS = 4            # overlapped_chunk: 64 256 samples in, 252 frames
STREAM_SECONDS = 10          # the clip the chunked and streamed paths serve
STREAM_KS = (1, 8, 16)       # streams of the latency and throughput readings
FEED_SAMPLES = 1600          # 100 ms feeds of those readings
MODE_SECONDS = 3             # the four modes' and the sub-band mode's clip
OOM_BATCH, OOM_SECONDS = 8, 30


def _launched(counts, before):
    return {k: v - before[k] for k, v in counts.items() if v != before[k]}


def _count(counts, fn, expected, what):
    """fn(), checked to launch exactly `expected` ({entry: launches})."""
    before = dict(counts)
    out = fn()
    launched = _launched(counts, before)
    check(launched == expected,
          f"{what} launched {expected} and nothing else (got {launched})")
    return out


def routed(entry, rows, out_f32=False, hsz=HIDDEN):
    """The entry kernel A ("lstm_scan_fwd"), B ("lstm_scan_fwd_carry") or C
    ("lstm_scan_fwd_train") launches for `rows` rows of an LSTM of hsz
    units on the card: the route of ops.lstm.plan_forward, the wide cluster
    ("_wide") or the resident one, whichever models faster there (within
    resident_forwards() or wide_forwards(), the one it forces); the GRU
    forward ("gru_scan_fwd") and carry ("gru_scan_fwd_carry") of a layer of
    hsz units likewise (ops.gru's route); kernel D
    ("lstm_scan_bwd") and the
    GRU backward scan ("gru_scan_bwd", a layer of hsz units) as
    ops.lstm.plan_bwd takes them (the wide cluster, "_wide", or the
    resident entry); any other entry as it is."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    if entry in ("lstm_scan_bwd", "gru_scan_bwd"):
        M = L if entry == "lstm_scan_bwd" else G
        plan = M.card_bwd_scan_plan(torch.device("cuda"), -(-hsz // 16) * 16,
                                    rows)
        return entry + ("_wide" if plan.design == "wide" else "")
    if entry in ("gru_scan_fwd", "gru_scan_fwd_carry"):
        return entry + G._forward_route(
            hsz, max(rows, 1), torch.device("cuda"),
            (int(out_f32), int(entry == "gru_scan_fwd_carry")))[1]
    if entry not in ("lstm_scan_fwd", "lstm_scan_fwd_carry",
                     "lstm_scan_fwd_train"):
        return entry
    return entry + L._forward_route(
        hsz, rows, torch.device("cuda"),
        (int(out_f32), int(entry == "lstm_scan_fwd_carry"),
         int(entry == "lstm_scan_fwd_train")))[1]


def routed_counts(*items):
    """{entry: launches} of (entry, rows, launches[, out_f32[, hsz]]) items,
    each entry of kernels A-D and of the GRU backward scan named as the
    route takes it at its rows."""
    out = {}
    for entry, rows, n, *rest in items:
        name = routed(entry, rows, *rest)
        out[name] = out.get(name, 0) + n
    return {k: n for k, n in out.items() if n}


def routed_step(per_step, rows=TRAIN_ROWS, fb_rows=TRAIN_BATCH):
    """A training step's {entry: launches} with kernel C's and D's entries
    named as the route takes them at `rows` sub-band rows (H=HIDDEN), and
    the GRU forward's and
    backward scan's (v1-GRU: half their launches over those rows, half over
    the full band's `fb_rows` at H=FB_HIDDEN) likewise."""
    items = []
    for k, n in per_step.items():
        if k in ("gru_scan_fwd", "gru_scan_bwd"):
            items += [(k, rows, n // 2), (k, fb_rows, n - n // 2, False,
                                          FB_HIDDEN)]
        else:
            items.append((k, rows, n))
    return routed_counts(*items)


# The entries of kernels A, B and C, both designs (the resident cluster of
# csrc/lstm_scan.cu and the wide one of csrc/lstm_scan_wide.cu), and of
# kernel D (the resident cluster of csrc/lstm_scan_bwd.cu and the wide one
# of csrc/lstm_scan_bwd_wide.cu).
AB_ENTRIES = ("lstm_scan_fwd", "lstm_scan_fwd_carry", "lstm_scan_fwd_wide",
              "lstm_scan_fwd_carry_wide")
# The GRU forward's and carry's entries, both designs (csrc/gru_scan.cu's
# resident cluster, csrc/gru_scan_wide.cu's wide one).
GRU_FWD_ENTRIES = ("gru_scan_fwd", "gru_scan_fwd_carry", "gru_scan_fwd_wide",
                   "gru_scan_fwd_carry_wide")
C_ENTRIES = ("lstm_scan_fwd_train", "lstm_scan_fwd_train_wide")
D_ENTRIES = ("lstm_scan_bwd", "lstm_scan_bwd_wide")
GRU_BWD_ENTRIES = ("gru_scan_bwd", "gru_scan_bwd_wide")


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _noise(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


def _streamed(stream, noisy, seed, low=1, high=24000):
    """Feed `noisy` ([L] or [K, L]) in pieces of seeded random sizes and
    flush: the concatenated output."""
    rng = np.random.default_rng(seed)
    pieces, pos = [], 0
    while pos < noisy.shape[-1]:
        n = int(rng.integers(low, high))
        pieces.append(stream.feed(noisy[..., pos:pos + n]))
        pos += n
    pieces.append(stream.flush())
    return np.concatenate(pieces, axis=-1)


class _Reshaped(torch.nn.Module):
    """A full-band SequenceModel (LSTM, FB_HIDDEN) behind the reshapes of
    one inference mode's convention."""

    def __init__(self, mode, dtype, device):
        from generative_audio_torch.nn.recurrent import SequenceModel
        super().__init__()
        f = 257
        n_in, n_out, act = {"mag": (f, f, "ReLU"),
                            "scaled_mask": (f, 2 * f, "Tanh"),
                            "complex_full_band_crm_mask": (2 * f, 2 * f, "Tanh"),
                            "time_domain": (250, 250, "Tanh")}[mode]
        self.mode = mode
        self.seq = SequenceModel(n_in, n_out, FB_HIDDEN, sequence_model="LSTM",
                                 output_activate_function=act,
                                 compute_dtype=dtype, device=device)

    def forward(self, x):
        b = x.shape[0]
        if self.mode == "time_domain":    # frames of 250 (a bucket divides)
            y = self.seq(x.reshape(b, -1, 250).transpose(1, 2))
            return y.transpose(1, 2).reshape(b, -1)
        y = self.seq(x.reshape(b, -1, x.shape[-1]))
        return y.reshape(b, 1 if self.mode == "mag" else 2, 257, -1)


def _card_and_cpu(make, seed):
    """The same weights (torch's initialisers drawn from `seed`) in a bf16
    model, for the card, and a float32 one, for the CPU."""
    torch.manual_seed(seed)
    ref = make(torch.float32, "cpu")
    model = make(torch.bfloat16, "cpu")
    model.load_state_dict(ref.state_dict())
    return model, ref


def _serve_modes(dev, counts, card):
    """The sub-band mode (FullSubNet's sub-band width: SequenceModel(31, 2,
    HIDDEN), 257 rows) and the four modes around a full-band LSTM, one 3 s
    clip each, card against CPU."""
    from generative_audio_torch.eval import Inferencer, InferencerConfig
    from generative_audio_torch.nn.recurrent import SequenceModel
    noisy = _noise(SEED + 20, MODE_SECONDS * 16000)
    models = {"sub_band_crm_mask": lambda dtype, device: SequenceModel(
        31, 2, HIDDEN, num_layers=2, sequence_model="LSTM",
        output_activate_function=None, compute_dtype=dtype, device=device)}
    for mode in ("mag", "scaled_mask", "complex_full_band_crm_mask",
                 "time_domain"):
        models[mode] = lambda dtype, device, mode=mode: _Reshaped(
            mode, dtype, device)
    for i, (mode, make) in enumerate(models.items()):
        model, ref = _card_and_cpu(make, SEED + 21 + i)
        cfg = InferencerConfig(inference_type=mode)
        inf = Inferencer(model, cfg, device=dev)
        # the sub-band model over a clip's 257 rows, the full band's over 1
        rows, h = ((ROWS // 8, HIDDEN) if mode == "sub_band_crm_mask"
                   else (1, FB_HIDDEN))
        got = _count(counts, lambda: inf.enhance(noisy),
                     {routed("lstm_scan_fwd", rows, hsz=h): 2},
                     f"mode {mode}")
        want = Inferencer(ref, cfg, device="cpu").enhance(noisy)
        rel = _rel(got, want)
        log(f"mode {mode}: {MODE_SECONDS} s clip, rtf {inf.last_rtf:.5f}; card "
            f"(bf16) vs CPU (float32) max|err|/peak {rel:.3e} on {card}")
        check(got.shape == noisy.shape and np.isfinite(got).all()
              and rel < PATH_REL, f"mode {mode}: card vs CPU within {PATH_REL}")


def _chunks_and_streams(dev, model, ref, counts, card):
    """overlapped_chunk (4 s chunks) against the float32 model on the CPU;
    StreamingEnhancer at K = 1 and 8, async_depth 0 and 2, against it bit
    for bit; each of the 8 rows against its single stream."""
    from generative_audio_torch.eval import (
        Inferencer, InferencerConfig, StreamingEnhancer)
    cfg = InferencerConfig(inference_type="overlapped_chunk",
                           chunk_model="spectral",
                           chunk_length_seconds=CHUNK_SECONDS)
    inf = Inferencer(model, cfg, device=dev)
    chunk = cfg.sr * CHUNK_SECONDS
    n_chunks = int(STREAM_SECONDS * cfg.sr / (chunk // 2)) + 1
    # each chunk over the 257 rows of each stream, as the route takes them
    per_run = {k: routed_counts(("lstm_scan_fwd", k * ROWS // 8,
                                 2 * n_chunks)) for k in (1, 8)}
    noisy = _noise(SEED + 30, 8, STREAM_SECONDS * cfg.sr)
    got = _count(counts, lambda: inf.enhance(noisy[0]), per_run[1],
                 "overlapped_chunk")
    want = Inferencer(ref, cfg, device="cpu").enhance(noisy[0])
    rel = _rel(got, want)
    log(f"overlapped_chunk: {STREAM_SECONDS} s clip, {n_chunks} chunks of "
        f"{chunk + 256} samples ({(chunk + 256) // 256 + 1} frames), rtf "
        f"{inf.last_rtf:.5f}; card (bf16) vs CPU (float32) max|err|/peak "
        f"{rel:.3e} on {card}")
    check(got.shape == (STREAM_SECONDS * cfg.sr,) and np.isfinite(got).all()
          and rel < PATH_REL, f"overlapped_chunk vs the CPU within {PATH_REL}")
    offline = {1: got}
    offline[8] = _count(counts, lambda: inf.overlapped_chunk(noisy),
                        per_run[8], "overlapped_chunk, 8 rows")
    for k in (1, 8):
        rows = noisy[0] if k == 1 else noisy
        for depth in (0, 2):
            stream = StreamingEnhancer(inf, n_streams=k, async_depth=depth)
            out = _count(counts,
                         lambda: _streamed(stream, rows, SEED + k + depth),
                         per_run[k], f"stream K={k} depth {depth}")
            check(np.array_equal(out, offline[k]),
                  f"K={k} streams, async_depth {depth} == overlapped_chunk of "
                  f"{k} rows bit for bit")
    worst = 0.0
    for row in range(8):
        single = _streamed(StreamingEnhancer(inf), noisy[row], SEED + 40 + row)
        worst = max(worst, _rel(offline[8][row], single))
    log(f"stream: K=1 and 8 at async_depth 0 and 2 == overlapped_chunk of as "
        f"many rows bit for bit; the 8 rows vs their single streams max|err|/"
        f"peak {worst:.3e}")
    check(worst < PATH_REL, f"K=8 rows vs single streams within {PATH_REL}")


def _stream_readings(dev, model, card):
    """Per-chunk time on the card, feed-to-finalized latency and aggregate
    x realtime at K = 1, 8, 16 streams, 100 ms feeds, 4 s and 1 s chunks."""
    from generative_audio_torch.eval import (
        Inferencer, InferencerConfig, StreamingEnhancer)
    for seconds in (CHUNK_SECONDS, 1):
        cfg = InferencerConfig(chunk_model="spectral",
                               chunk_length_seconds=seconds)
        inf = Inferencer(model, cfg, device=dev)
        n_in = cfg.sr * seconds + 256
        program = inf._chunk_program()
        for k in STREAM_KS:
            x = torch.randn(k, n_in, device=dev) * 0.1
            with torch.inference_mode():
                chunk_ms = cuda_ms(lambda: program(x), 10, warmup=3)
            wavs = _noise(SEED + 50 + k, k, STREAM_SECONDS * cfg.sr)
            for depth in (0, 2):
                stream = StreamingEnhancer(inf, n_streams=k, async_depth=depth)
                stream.feed(wavs[:, :n_in])     # warm the shapes
                stream.flush()
                finalize_ms = []
                t0 = time.perf_counter()
                for pos in range(0, wavs.shape[-1], FEED_SAMPLES):
                    f0 = time.perf_counter()
                    out = stream.feed(wavs[:, pos:pos + FEED_SAMPLES])
                    if out.shape[-1]:
                        finalize_ms.append((time.perf_counter() - f0) * 1e3)
                stream.flush()
                wall = time.perf_counter() - t0
                log(f"stream {seconds} s chunks ({n_in // 256 + 1} frames), "
                    f"K={k}, async_depth {depth}: chunk {chunk_ms:.3f} ms on "
                    f"the card (CUDA events); feed-to-finalized p50 "
                    f"{statistics.median(finalize_ms):.2f} ms over "
                    f"{len(finalize_ms)} feeds; aggregate "
                    f"{k * STREAM_SECONDS / wall:.1f}x realtime "
                    f"({STREAM_SECONDS / wall:.1f}x a stream); on {card}")


def _batched_dir(dev, inf, counts, card, phase4_rtf):
    """enhance_dir over mixed buckets (8 x 10 s, 5 x 7.5 s) at batch 8
    against the serial path, then one real halving: a memory limit under
    which a batch of 30 s clips runs out."""
    from generative_audio_torch.data import read_wav
    clips = [(_noise(SEED + 60 + i, 160000), f"ten{i}") for i in range(8)]
    clips += [(_noise(SEED + 70 + i, 120000), f"sevenhalf{i}") for i in range(5)]
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for batch in (8, 1):
            # batch 8: each bucket warmed once at its batch, then served
            # batch 8: each bucket (8 x 10 s, 5 x 7.5 s) warm and served;
            # batch 1: each of the 13 clips, each over 257 rows
            _count(counts, lambda: inf.enhance_dir(
                clips, Path(tmp) / str(batch), log=lambda *_: None,
                batch_size=batch), routed_counts(
                    ("lstm_scan_fwd", 8 * ROWS // 8, 4),
                    ("lstm_scan_fwd", 5 * ROWS // 8, 4)) if batch == 8
                else routed_counts(("lstm_scan_fwd", ROWS // 8, 26)),
                f"enhance_dir, batch {batch}")
            out[batch] = {name: read_wav(Path(tmp) / str(batch) / f"{name}.wav")
                          for _, name in clips}
            if batch == 8:
                rtf = inf.last_rtf
        steps = max(float(np.abs(out[8][name][1] - out[1][name][1]).max())
                    for _, name in clips) * 32768
        # 0.8 is the written peak: the same bf16 limit as chunked against
        # unchunked, since another batch sums the projections, norms and
        # convolutions in another order
        log(f"enhance_dir 8 x 10 s + 5 x 7.5 s, batch 8: rtf {rtf:.5f} (phase "
            f"4's batch of 8 x 10 s: {phase4_rtf:.5f}); batched vs serial max "
            f"{steps:.0f} int16 steps ({steps / 32768 / 0.8:.3e} of the peak); "
            f"on {card}")
        for noisy, name in clips:
            sr, wav = out[8][name]
            check(sr == 16000 and wav.shape == noisy.shape
                  and np.isfinite(wav).all(), f"enhance_dir wrote {name}")
        check(steps / 32768 / 0.8 < PATH_REL,
              f"batched enhance_dir vs serial within {PATH_REL} of the peak")
        _halving(dev, inf, Path(tmp))


def _batch_parts(dev, model, card):
    """Where a batch of 8 clips and its first clip alone part: the
    full-band tower's output (convolutions and norms over another batch sum
    in another order) and so the sub-band input differ, while the sub-band
    model (the projections and kernel A) on the same 257 rows, among 2056
    or alone, gives the same bits."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen.setdefault(name, []).append((args[0], out))
        return hook

    hooks = [model.get_submodule(name).register_forward_hook(keep(name))
             for name in ("fb_model", "sb_model")]
    wav = torch.from_numpy(_noise(SEED + 60, 8, 160000)).to(dev)
    with torch.inference_mode():
        for batch in (8, 1):
            model(*prepare_input_from_waveform(wav[:batch], 512, 256, 512))
        for hook in hooks:
            hook.remove()
        (fb8, fb1), (sb8, sb1) = seen["fb_model"], seen["sb_model"]
        fb = float((fb8[1][:1] - fb1[1]).abs().max() / fb1[1].abs().max())
        sb_in = float((sb8[0][:257] - sb1[0]).abs().max())
        alone = model.sb_model(sb8[0][:257].contiguous())
        same = torch.equal(alone, sb8[1][:257])
    log(f"batch 8 vs its first clip alone: full-band tower output max|diff|/"
        f"peak {fb:.3e}, sub-band input max|diff| {sb_in:.3e}; the sub-band "
        f"model on the same 257 rows, among 2056 vs alone, bit for bit: "
        f"{same}; on {card}")
    check(same, "the sub-band model's rows do not depend on the batch")


def _tcn_block_ops(block):
    """TCNBlock.forward as its ops, in order: (name, fn, feeds_next). An op
    that does not feed the next one is a reading of part of the next op
    (the norms' mean and variance)."""
    import torch.nn.functional as F
    cdt, dw = block.compute_dtype, block.depthwise_conv

    def depthwise(y):
        y = F.conv1d(F.pad(y.transpose(1, 2).to(cdt), block.padding),
                     dw.weight.to(cdt), dw.bias.to(cdt), dilation=dw.dilation,
                     groups=dw.groups)
        return y.transpose(1, 2).float()

    def mean(y):
        return y.mean(dim=(1, 2), keepdim=True)

    def var(y):
        return y.var(dim=(1, 2), keepdim=True, unbiased=False)

    return [("conv1x1 (bf16 F.linear, M = B*T)",
             lambda y: block._pointwise(block.conv1x1, y), True),
            ("prelu1", block.prelu1, True),
            ("norm1 mean over (T, C)", mean, False),
            ("norm1 variance over (T, C)", var, False),
            ("norm1", block.norm1, True),
            ("depthwise conv (bf16 F.conv1d)", depthwise, True),
            ("prelu2", block.prelu2, True),
            ("norm2 mean over (T, C)", mean, False),
            ("norm2 variance over (T, C)", var, False),
            ("norm2", block.norm2, True),
            ("sconv (bf16 F.linear, M = B*T)",
             lambda y: block._pointwise(block.sconv, y), True)]


def _batch_trace(dev, model, card):
    """Where clip 0 of a batch of 8 x 10 s and clip 0 alone part, block by
    block and op by op through FullSubNet+'s three TCN towers. Each op of
    each block is given the batch's own input to it, once as the batch and
    once as row 0 alone, so that an op that does not depend on the batch
    reads 0 whatever the ops before it did. Logs the largest difference of
    each op as a share of its output's peak, and the first op (tower,
    block, op) whose row 0 differs."""
    from generative_audio_torch.ops import prepare_input_from_waveform
    towers = ("fb_model", "fb_model_real", "fb_model_imag")
    inputs, alone = {}, {}
    seen = inputs

    def keep(name):
        def hook(module, args, out):
            seen[name] = args[0]
        return hook

    blocks = {(t, i): model.get_submodule(f"{t}.sequence_model.{i}")
              for t in towers for i in range(8)}
    hooks = [b.register_forward_hook(keep(k)) for k, b in blocks.items()]
    wav = torch.from_numpy(_noise(SEED + 60, 8, 160000)).to(dev)
    worst, first = {}, None
    try:
        with torch.inference_mode():
            model(*prepare_input_from_waveform(wav, 512, 256, 512))
            seen = alone
            model(*prepare_input_from_waveform(wav[:1], 512, 256, 512))
            # what reaches each tower (STFT, norm, TSSE) in the two runs
            upstream = max(float((inputs[(t, 0)][:1] - alone[(t, 0)]).abs()
                                 .max() / alone[(t, 0)].abs().max())
                           for t in towers)
            for key, block in blocks.items():
                x8 = inputs[key].float()                 # [8, T, 257]
                for name, fn, feeds in _tcn_block_ops(block):
                    y8, y1 = fn(x8), fn(x8[:1].contiguous())
                    diff = float((y8[:1] - y1).abs().max()
                                 / y1.abs().max().clamp_min(1e-30))
                    worst[name] = max(worst.get(name, 0.0), diff)
                    if diff > 0 and first is None:
                        first = (*key, name, diff)
                    if feeds:
                        x8 = y8
    finally:
        for hook in hooks:
            hook.remove()
    log("batch trace, FullSubNet+'s TCN towers, batch 8 x 10 s vs its first "
        "clip alone on the same input to each op (max|diff| / peak, worst of "
        "24 blocks): " + "; ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; on {card}")
    log(f"batch trace: the towers' inputs (STFT, norm, TSSE), batch vs alone: "
        f"max|diff|/peak {upstream:.3e}")
    log("batch trace: first op whose clip-0 output depends on the batch: "
        + (f"{first[0]} block {first[1]}, {first[2]} ({first[3]:.3e} of its "
           "peak)" if first else "none"))


def _halving(dev, inf, tmp):
    """One real halving: the memory limit is what is reserved now plus what
    a batch of two 30 s clips takes, so that a batch of 8 (four times that)
    runs out. Free space inside segments that are reserved may let a batch
    of 4 fit, so the check is that the batch halved and every clip was
    written, not how often."""
    from generative_audio_torch.data import read_wav
    long = [(_noise(SEED + 80 + i, OOM_SECONDS * 16000), f"long{i}")
            for i in range(OOM_BATCH)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    inf.enhance_dir(long[:2], tmp / "batch2", log=lambda *_: None,
                    batch_size=2)
    need2 = torch.cuda.max_memory_allocated(dev) - start
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    limit = reserved + need2
    total = torch.cuda.get_device_properties(dev).total_memory
    logs = []
    torch.cuda.set_per_process_memory_fraction(limit / total, dev)
    try:
        inf.enhance_dir(long, tmp / "long", log=logs.append,
                        batch_size=OOM_BATCH)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    retries = [line for line in logs if "retrying" in line]
    log(f"enhance_dir {OOM_BATCH} x {OOM_SECONDS} s: a batch of 2 takes "
        f"{need2 / 2 ** 30:.2f} GiB; {reserved / 2 ** 30:.2f} GiB reserved "
        f"({torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} allocated), limit "
        f"{limit / 2 ** 30:.2f} GiB: {retries}")
    check(retries and retries[0].startswith(
        f"bucket {OOM_SECONDS * 16000}: batch {OOM_BATCH} ran out of device "
        "memory"), f"the batch of {OOM_BATCH} x {OOM_SECONDS} s clips halved "
        "under the memory limit")
    for noisy, name in long:
        sr, wav = read_wav(tmp / "long" / f"{name}.wav")
        check(wav.shape == noisy.shape and np.isfinite(wav).all(),
              f"enhance_dir wrote {name} after halving")


def _cli(dev, plus, counts, card):
    """generative_audio_torch.cli.inference in process, a JSON config and a
    .pth of the seeded weights, three wavs, on the card and on the CPU."""
    from generative_audio_torch.cli.inference import main as cli_main
    from generative_audio_torch.data import read_wav, write_wav
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "noisy").mkdir()
        for i, seconds in enumerate((0.5, 0.75, 1.0)):
            write_wav(root / "noisy" / f"c{i}.wav",
                      _noise(SEED + 90 + i, int(seconds * 16000)), 16000)
        torch.save({"model": plus.sd}, root / "model.pth")
        (root / "cfg.json").write_text(json.dumps(
            {"inferencer": {"length_bucket": 4000}}))
        for device in (str(dev), "cpu"):
            argv = ["-C", str(root / "cfg.json"), "-M", str(root / "model.pth"),
                    "-I", str(root / "noisy"), "-O", str(root / device),
                    "--device", device]
            _count(counts, lambda: cli_main(argv),
                   routed_counts(("lstm_scan_fwd", ROWS // 8, 6))
                   if device != "cpu" else {}, f"the CLI on {device}")
        worst = 0.0
        for i in range(3):
            got = read_wav(root / str(dev) / f"c{i}.wav")[1]
            want = read_wav(root / "cpu" / f"c{i}.wav")[1]
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"the CLI wrote c{i}.wav")
            worst = max(worst, _rel(got, want))
        log(f"cli: 3 wavs, card vs CPU (both bf16) max|err|/peak {worst:.3e} "
            f"on {card}")
        check(worst < PATH_REL, f"the CLI, card vs CPU within {PATH_REL}")


def phase_serving_modes(dev, plus, phase4_rtf):
    """Phase 13. Returns the launches of its kernels."""
    from generative_audio_torch.ops import lstm as L
    card = card_line()
    model = plus.model(torch.bfloat16, dev)
    ref = plus.model(torch.float32, "cpu")
    L.reset_launch_counts()
    counts = L.launch_counts
    _chunks_and_streams(dev, model, ref, counts, card)
    _serve_modes(dev, counts, card)
    _batched_dir(dev, plus.inferencer(model, dev), counts, card, phase4_rtf)
    _batch_parts(dev, model, card)
    _batch_trace(dev, model, card)
    _cli(dev, plus, counts, card)
    launched = {k: v for k, v in counts.items() if v}
    log(f"launches on the serving path of phase 13: {launched}")
    check(set(launched) <= {"lstm_scan_fwd", "lstm_scan_fwd_wide"},
          f"phase 13 launched kernel A, as the route takes it at each call's "
          f"rows, and nothing else (got {launched})")
    _stream_readings(dev, model, card)
    return launched


# Phase 14: validation and best-model selection inside training, FullSubNet+
# at full width. V: four (noisy, clean) pairs, P: two more at another SNR.
VAL_SECONDS, VAL_SNR = (3.0, 10.0, 5.5, 7.25), 5.0
PROBE_SECONDS, PROBE_SNR = (4.0, 6.5), -2.0
VAL_EPOCHS = 2
# The 10 s clip of V (628 frames x 257 rows) runs under this gates limit,
# so the sub-band LSTM takes the chunked path (kernel B) for it alone.
VAL_CHUNKED, VAL_GATES_LIMIT = 1, 256 << 20
# The card's bf16 validation means against ModelValidator on the float32
# model on the CPU with the same weights (V's four clips), absolute: on an
# H100 they measured 3.5e-6 (STOI), 5.5e-4 dB (SI_SDR) and 1.1e-5 (WB_PESQ),
# a clip at most 2.8e-5, 1.2e-3 dB and 2.8e-5; margins of about 20x over
# the means.
VAL_STOI_ABS, VAL_SI_SDR_ABS, VAL_PESQ_ABS = 1e-4, 1e-2, 2e-4


def _speech_like(seed, seconds, fs=16000):
    """Speech-like audio: harmonic bursts with a wandering f0 separated by
    near-silent pauses (the utterances P.862's VAD looks for) over a faint
    noise floor; peak 1."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = 120.0 * (1.0 + 0.2 * np.sin(2 * np.pi * 1.3 * t
                                     + rng.uniform(0, 2 * np.pi))
                  + 0.08 * np.sin(2 * np.pi * 3.1 * t
                                  + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    voiced = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k
                 for k in range(1, 9))
    env = np.zeros(n)
    pos = 0.1
    while pos < seconds - 0.4:
        dur = rng.uniform(0.25, 0.5)
        i0, i1 = int(pos * fs), min(int((pos + dur) * fs), n)
        env[i0:i1] = (np.sin(np.pi * np.arange(i1 - i0) / (i1 - i0)) ** 0.5
                      * rng.uniform(0.6, 1.0))
        pos += dur + rng.uniform(0.15, 0.4)
    out = voiced * env + 2e-4 * rng.standard_normal(n)
    return out / np.max(np.abs(out))


def _speech_pair(seed, seconds, snr_db):
    """(noisy, clean) float32 at peak 0.5: speech-like audio plus seeded
    white noise at snr_db."""
    clean = 0.5 * _speech_like(seed, seconds)
    noise = np.random.default_rng(seed + 1).standard_normal(len(clean))
    noise *= np.sqrt(np.mean(clean ** 2) / np.mean(noise ** 2)
                     / 10 ** (snr_db / 10))
    return (clean + noise).astype(np.float32), clean.astype(np.float32)


class _LimitedClip:
    """V as a dataset: while item `index` is enhanced, the model's LSTM layers
    take `limit` as their gates limit, and their own limit for every other
    item. The validator launches an item's enhancement before it fetches
    the next item, so the limit holds for that item's forward alone."""

    def __init__(self, pairs, model, index, limit):
        from generative_audio_torch.nn.recurrent import LSTMLayer
        self.pairs, self.index, self.limit = pairs, index, limit
        self.layers = {m: m.gates_bytes_limit for m in model.modules()
                       if isinstance(m, LSTMLayer)}

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        for layer, own in self.layers.items():
            layer.gates_bytes_limit = self.limit if i == self.index else own
        return self.pairs[i]


def _chunks(frames, rows, hidden, limit):
    """Chunks of the time-chunked LSTM layer at this limit: a chunk holds
    max(64, ceil(limit * share / bytes of one frame's bf16 gates)) frames."""
    from generative_audio_torch.nn import recurrent
    row_bytes = rows * 4 * hidden * 2
    t_chunk = max(64, -(-int(limit * recurrent._CHUNK_SHARE_OF_LIMIT)
                        // row_bytes))
    return -(-frames // t_chunk)


@contextlib.contextmanager
def _timed_validator(readings):
    """ModelValidator, as the trainer builds it, with each clip's
    enhancement timed on the card (CUDA events around the launches; read
    after the validation) and on the host clock (the launches), and each
    clip's host metrics timed on the host clock; per-clip scores kept."""
    from generative_audio_torch.eval import validator as VM
    base = VM.ModelValidator

    class Timed(base):
        def _enhance(self, noisy):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = super()._enhance(noisy)
            end.record()
            readings["launch_s"].append(time.perf_counter() - t0)
            readings["events"].append((start, end))
            return out

        def calculate_metrics(self, clean, enhanced):
            t0 = time.perf_counter()
            out = super().calculate_metrics(clean, enhanced)
            readings["host_s"].append(time.perf_counter() - t0)
            readings["scores"].append(out)
            return out

    VM.ModelValidator = Timed
    try:
        yield
    finally:
        VM.ModelValidator = base


def phase_validation(dev, plus):
    """Phase 14: EnhanceTrainer.train with validation and a probe at weight
    0.5 at FullSubNet+'s full width, bf16. Returns the launches of its
    kernels."""
    from generative_audio_torch.eval.validator import ModelValidator
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import EnhanceTrainer
    card = card_line()
    cfg = plus.train_config("bfloat16")
    # phase 6's seeded weights, with the sub-band output layer near the
    # identity mask (kernel x 0.1, bias the compressed mask of 1): with a
    # random mask the enhanced clip is near silence and the metrics read
    # nothing of the path
    from generative_audio_torch.ops.mask import compress_cIRM
    sd = dict(plus.sd)
    sd["sb_model.fc_output_layer.weight"] = \
        sd["sb_model.fc_output_layer.weight"] * 0.1
    sd["sb_model.fc_output_layer.bias"] = torch.tensor(
        [compress_cIRM(torch.ones(())).item(), 0.0])
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    loader = [(noisy, clean)]
    val_pairs = [_speech_pair(SEED + 100 + i, s, VAL_SNR)
                 for i, s in enumerate(VAL_SECONDS)]
    probe = [_speech_pair(SEED + 110 + i, s, PROBE_SNR)
             for i, s in enumerate(PROBE_SECONDS)]
    frames = int(VAL_SECONDS[VAL_CHUNKED] * 16000) // 256 + 1 + 2
    n_chunks = _chunks(frames, 257, HIDDEN, VAL_GATES_LIMIT)
    # each clip alone: 257 sub-band rows, as the route takes them
    per_val = routed_counts(
        ("lstm_scan_fwd", ROWS // 8, 2 * (len(VAL_SECONDS) - 1)),
        ("lstm_scan_fwd_carry", ROWS // 8, 2 * n_chunks))
    per_probe = routed_counts(("lstm_scan_fwd", ROWS // 8,
                               2 * len(PROBE_SECONDS)))
    per_step = routed_step({"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2})

    readings = {"events": [], "launch_s": [], "host_s": [], "scores": []}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = EnhanceTrainer(cfg, checkpoint_dir=Path(tmp) / "ckpt",
                                 seed=SEED, pretrained_state_dict=sd,
                                 device=dev)
        val = _LimitedClip(val_pairs, trainer.state.model, VAL_CHUNKED,
                           VAL_GATES_LIMIT)
        calls, walls, means = [], [], []
        validate = trainer.validate

        def counted(dataset, max_items=10):
            before = dict(L.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(dataset, max_items)
            walls.append((time.perf_counter() - t0, len(dataset)))
            calls.append({k: L.launch_counts[k] - before[k]
                          for k in L.launch_counts
                          if L.launch_counts[k] != before[k]})
            means.append((dataset is val, out))
            return out

        trainer.validate = counted
        L.reset_launch_counts()
        with _timed_validator(readings):
            trainer.train(loader, epochs=VAL_EPOCHS, val_dataset=val,
                          validation_interval=1, probe_dataset=probe,
                          probe_weight=0.5, log=log)
        launched = {k: v for k, v in L.launch_counts.items() if v}
        log(f"launches on the validation path of phase 14: {launched}; per "
            f"validation {calls}")
        chunked = VAL_SECONDS[VAL_CHUNKED]
        check(calls == [per_val, per_probe] * VAL_EPOCHS,
              f"each validation of V launched {per_val} (the {chunked} s clip "
              f"in {n_chunks} chunks a layer) and of P {per_probe}, nothing "
              f"else (got {calls})")
        want = {k: VAL_EPOCHS * (per_val.get(k, 0) + per_probe.get(k, 0)
                                 + per_step.get(k, 0))
                for k in {**per_val, **per_probe, **per_step}}
        check(launched == want,
              f"phase 14 launched {want} and nothing else (got {launched})")

        n_clips = len(VAL_SECONDS) + len(PROBE_SECONDS)
        check(len(readings["scores"]) == VAL_EPOCHS * n_clips,
              "every clip of V and P was scored")
        for scores in readings["scores"]:
            check(all(scores[k] is not None and np.isfinite(scores[k])
                      for k in ("STOI", "SI_SDR", "WB_PESQ")),
                  f"finite STOI, SI_SDR and WB_PESQ on every clip ({scores})")
        ckpt = trainer.ckpt
        meta = ckpt.best_meta()
        latest = torch.load(ckpt.path("latest"), map_location="cpu",
                            weights_only=True)
        check(meta is not None and meta["probe_weight"] == 0.5
              and latest["best_score"] == meta["score"] == trainer.best_score,
              f"best_score.json with probe_weight 0.5, latest.pt with the "
              f"same best score ({meta}, latest {latest['best_score']})")
        report = (ckpt.directory / "report.html").read_text()
        check(report.count("<polyline") == 2
              and 'data-label="validation"' in report,
              "report.html written with the loss and validation series")
        check(trainer.state.model.training,
              "the model is back in training mode")
        # the weights V was last validated with, for the float32 reference
        final_sd = {k: v.float().cpu()
                    for k, v in trainer.state.model.state_dict().items()}
        log(f"validation: val_history {trainer.val_history}, probe_history "
            f"{trainer.probe_history}, best {meta}")

        # validation left training as it found it: the step checkpoint
        # saved just before the last validation, loaded into a second
        # trainer, equals the first trainer bit for bit, and the next
        # step's loss (its forward, before the update) is the same
        twin = EnhanceTrainer(cfg, seed=SEED, pretrained_state_dict=sd,
                              device=dev)
        tree = ckpt.restore(f"step_{trainer.state.step:08d}")
        twin.state.load_state_dict(tree)
        same = all(torch.equal(a, b) for a, b in zip(
            trainer.state.model.state_dict().values(),
            twin.state.model.state_dict().values()))
        opt_a, opt_b = (t.state.optimizer.state_dict()["state"]
                        for t in (trainer, twin))
        same_opt = all(torch.equal(opt_a[i][n], opt_b[i][n]) for i in opt_a
                       for n in ("exp_avg", "exp_avg_sq", "step"))
        loss_a = trainer.train_epoch(loader)
        loss_b = twin.train_epoch(loader)
        log(f"validation: after it the parameters {'==' if same else '!='} "
            f"and the optimizer state {'==' if same_opt else '!='} the step "
            f"checkpoint saved before it; next step's loss {loss_a!r} vs "
            f"{loss_b!r} without the validation")
        check(same and same_opt and trainer.state.step == twin.state.step
              and loss_a == loss_b,
              "a training step after validation equals one without it")
        del trainer, twin

    # the card's numbers: wall per clip, time on the card, host metrics
    torch.cuda.synchronize()
    card_ms = [s.elapsed_time(e) for s, e in readings["events"]]
    host_s = sum(readings["host_s"])
    wall_s = sum(w for w, _ in walls)
    clips = sum(n for _, n in walls)
    launch_s = sum(readings["launch_s"])
    hidden = wall_s <= host_s + max(card_ms) / 1e3
    log(f"validation: {len(walls)} validations, {clips} clips of "
        f"{min(VAL_SECONDS + PROBE_SECONDS)}-{max(VAL_SECONDS + PROBE_SECONDS)}"
        f" s: wall {wall_s * 1e3 / clips:.2f} ms per clip; on the card "
        f"(CUDA events, enhancement) {sum(card_ms) / clips:.2f} ms per clip "
        f"(longest {max(card_ms):.2f}), of which the host spent "
        f"{launch_s * 1e3 / clips:.2f} ms launching it; host metrics (STOI, "
        f"SI_SDR, WB_PESQ) {host_s * 1e3 / clips:.2f} ms per clip; the "
        f"depth-2 pipeline hides the card (wall <= host metrics + one clip's "
        f"enhancement): {hidden}; on {card}")

    # the card's bf16 validation of V against the float32 model on the CPU
    ref_model = plus.model_cls(plus.config, compute_dtype=torch.float32,
                               device="cpu")
    ref_model.load_state_dict(final_sd)
    names = ("STOI", "SI_SDR", "WB_PESQ")
    ref_v = ModelValidator(ref_model, metric_names=names, device="cpu")
    ref_clips = [ref_v.calculate_metrics(c, ref_v.enhance_audio(n))
                 for n, c in val_pairs]
    ref = {k: float(np.mean([r[k] for r in ref_clips])) for k in names}
    got = [m for is_val, m in means if is_val][-1]
    # the last validation of V: the first clips of the last epoch's scores
    card_clips = readings["scores"][-n_clips:][:len(VAL_SECONDS)]
    gaps = {k: abs(got[k] - ref[k]) for k in names}
    worst = {k: max(abs(a[k] - b[k]) for a, b in zip(card_clips, ref_clips))
             for k in names}
    log(f"validation of V, card (bf16) vs CPU (float32), same weights: "
        + ", ".join(f"{k} {got[k]:.5f} vs {ref[k]:.5f} (|diff| {gaps[k]:.2e},"
                    f" largest of a clip {worst[k]:.2e})" for k in names))
    check(gaps["STOI"] <= VAL_STOI_ABS and gaps["SI_SDR"] <= VAL_SI_SDR_ABS
          and gaps["WB_PESQ"] <= VAL_PESQ_ABS,
          f"bf16 validation vs float32: |dSTOI| <= {VAL_STOI_ABS}, |dSI_SDR| "
          f"<= {VAL_SI_SDR_ABS} dB, |dWB_PESQ| <= {VAL_PESQ_ABS}")
    return {k: v for k, v in launched.items() if k in AB_ENTRIES}



# Phase 15: training from a corpus on disk through the training CLI,
# FullSubNet+ at full width (configs/enhance_train.yaml's model), bf16. The
# corpus: clean and noise clips of write_synthetic_corpus, some clean clips
# also as FLAC (verbatim frames of tests/flac_writer.py), RIRs of
# make_rir_bank, scp lists of cli/tools.gen_lst, a validation set V and a
# probe set P of TestSampleGenerator pairs.
CORPUS_CLEAN, CORPUS_NOISE, CORPUS_SECONDS = 36, 6, 6.0
CORPUS_RIRS, CORPUS_FLAC = 8, 4
CORPUS_VAL, CORPUS_VAL_SECONDS, CORPUS_VAL_SNR = 4, 6.0, 5.0
CORPUS_PROBE, CORPUS_PROBE_SECONDS, CORPUS_PROBE_SNR = 2, 3.0, -2.0
CORPUS_BATCH, CORPUS_WORKERS, CORPUS_EPOCHS = 18, 24, 2
# While the trainer validates, its LSTM layers take phase 14's lowered gates
# limit: a 6 s clip of V (378 frames x 257 rows, 298 MB of gates) exceeds
# it and takes kernel B, a 3 s clip of P (150 MB) kernel A.
CORPUS_VALIDATE_ITEMS = 8        # clips the validate CLI scores
# The A/B of a step fed by the loader against one from a batch in memory:
# rounds, and the pause before each step (a batch's mixing at 24 workers
# took about 90 ms on the card's host)
CORPUS_AB_ROUNDS, CORPUS_AB_PAUSE = 5, 0.3
# configs/enhance_train.yaml's model block
CORPUS_MODEL = {"num_freqs": 257, "look_ahead": 2, "sequence_model": "LSTM",
                "sb_num_neighbors": 15, "fb_num_neighbors": 0,
                "fb_output_activate_function": "ReLU",
                "fb_model_hidden_size": 512, "sb_model_hidden_size": 384,
                "channel_attention_model": "TSSE",
                "norm_type": "offline_laplace_norm",
                "num_groups_in_drop_band": 2, "kersize": [3, 5, 10]}


def _verbatim_flac(samples, block=4096):
    """16-bit mono FLAC bytes of int16 `samples`, verbatim subframes: after
    the byte-aligned frame and subframe headers of tests/flac_writer.py the
    samples go in as big-endian bytes. The writer is loaded by its path: a
    package named `tests` elsewhere on sys.path would shadow the repo's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "flac_writer", Path(__file__).resolve().parent / "tests"
        / "flac_writer.py")
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)

    def frame(chunk):
        def write(bw, _):
            writer._subframe_header(bw, 1)
            bw.bytes += chunk.astype(">i2").tobytes()
        return write

    chunks = [samples[i:i + block] for i in range(0, len(samples), block)]
    return writer.flac_stream([(len(c), 0, frame(c)) for c in chunks],
                              total=len(samples))


def _write_corpus(root):
    """The corpus of phase 15 under `root`; returns the config's data and
    validation blocks, the clean directory and the FLAC/WAV pairs."""
    from scipy.io import wavfile
    from generative_audio_torch.cli.tools import gen_lst
    from generative_audio_torch.data import (
        AudioDataSetConfig, TestSampleGenerator, make_rir_bank,
        write_synthetic_corpus)
    clean_dir, noise_dir = write_synthetic_corpus(
        root, n_clean=CORPUS_CLEAN, n_noise=CORPUS_NOISE,
        seconds=CORPUS_SECONDS, seed=SEED)
    rir_scp = make_rir_bank(root / "rir", n=CORPUS_RIRS, seed=SEED)
    gen_lst(noise_dir, root / "noise.scp")
    gen_lst(clean_dir, root / "clean.scp")
    (root / "flac").mkdir()
    flac_pairs = []
    for i in range(CORPUS_FLAC):
        wav = clean_dir / f"clean_{i}.wav"
        sr, pcm = wavfile.read(wav)
        flac = root / "flac" / f"clean_{i}.flac"
        flac.write_bytes(_verbatim_flac(pcm))
        flac_pairs.append((flac, wav))
    # the clean list names the FLAC copies in place of their WAVs
    swap = {str(w): str(f) for f, w in flac_pairs}
    lines = (root / "clean.scp").read_text().split()
    check(sum(line in swap for line in lines) == CORPUS_FLAC,
          "the clean scp lists the WAVs that get FLAC copies")
    (root / "clean.scp").write_text(
        "".join(f"{swap.get(line, line)}\n" for line in lines))
    for name, n, seconds, snr, seed in (
            ("val", CORPUS_VAL, CORPUS_VAL_SECONDS, CORPUS_VAL_SNR, SEED),
            ("probe", CORPUS_PROBE, CORPUS_PROBE_SECONDS, CORPUS_PROBE_SNR,
             SEED + 1)):
        TestSampleGenerator(AudioDataSetConfig(
            str(clean_dir), str(noise_dir),
            sub_sample_length_seconds=seconds), root / name, snr=snr,
            seed=seed).generate(n)
    data = {"clean_dataset": str(root / "clean.scp"),
            "noise_dataset": str(root / "noise.scp"),
            "rir_dataset": str(rir_scp), "snr_range": [-5, 20],
            "reverb_proportion": 0.75, "silence_length": 0.2,
            "target_dB_FS": -25, "target_dB_FS_floating_value": 10,
            "sub_sample_length": 3.072, "sr": 16000}
    validation = {"val_dir": str(root / "val"),
                  "probe_dir": str(root / "probe"), "probe_weight": 0.5,
                  "validation_interval": 1}
    return data, validation, clean_dir, noise_dir, flac_pairs


def _train_config(root, data, validation):
    """configs/enhance_train.yaml's keys and values, as JSON (PyYAML may be
    missing where the script runs), pointed at the corpus, validating every
    epoch with the probe at weight 0.5."""
    cfg = {"line": "enhance", "checkpoint_dir": str(root / "ckpt"),
           "train": {"model": CORPUS_MODEL, "n_fft": 512, "hop_length": 256,
                     "win_length": 512, "learning_rate": 0.001,
                     "betas": [0.9, 0.999], "clip_grad_norm": 10.0,
                     "compute_dtype": "bfloat16"},
           "validation": validation, "data": data,
           "dataloader": {"global_batch_size": CORPUS_BATCH,
                          "num_workers": CORPUS_WORKERS, "drop_last": True,
                          "seed": SEED}}
    path = root / "train.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path


@contextlib.contextmanager
def _instrumented_trainer(steps, validations, restores):
    """EnhanceTrainer as the CLI builds it, with each train step timed on
    the host clock (entered when the loader has delivered the batch, left
    after a synchronize) and its launches counted; each validation run under
    VAL_GATES_LIMIT with its launches counted; each restore_latest's result,
    step and best score recorded."""
    from generative_audio_torch.nn.recurrent import LSTMLayer
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import enhance as E
    make_step, validate = E.make_enhance_train_step, E.EnhanceTrainer.validate
    restore = E.EnhanceTrainer.restore_latest

    def make_timed(config, accum_steps=1, net=None, subband_sharding=None):
        step = make_step(config, accum_steps, net, subband_sharding)

        def timed(state, noisy, clean, global_rows=None):
            t0 = time.perf_counter()
            before = dict(L.launch_counts)
            state, loss = step(state, noisy, clean, global_rows)
            torch.cuda.synchronize()
            steps.append({"start": t0, "end": time.perf_counter(),
                          "step": state.step, "loss": loss.item(),
                          "launched": _launched(L.launch_counts, before),
                          "rows": tuple(noisy.shape)})
            return state, loss
        return timed

    def limited_validate(self, dataset, max_items=10):
        layers = [m for m in self.state.model.modules()
                  if isinstance(m, LSTMLayer)]
        own = [m.gates_bytes_limit for m in layers]
        before = dict(L.launch_counts)
        for m in layers:
            m.gates_bytes_limit = VAL_GATES_LIMIT
        try:
            out = validate(self, dataset, max_items)
        finally:
            for m, limit in zip(layers, own):
                m.gates_bytes_limit = limit
        validations.append((len(dataset), _launched(L.launch_counts, before), out))
        return out

    def recorded_restore(self):
        out = restore(self)
        restores.append((out, self.state.step, self.best_score))
        return out

    with mock.patch.object(E, "make_enhance_train_step", make_timed), \
            mock.patch.object(E.EnhanceTrainer, "validate", limited_validate), \
            mock.patch.object(E.EnhanceTrainer, "restore_latest",
                              recorded_restore):
        yield


@contextlib.contextmanager
def _hidden_module(name):
    """`import name` raises ImportError inside the block."""
    missing = object()
    saved = sys.modules.get(name, missing)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def _loader_pass(config, workers):
    """One epoch of BatchLoader over a fresh DNSTrainDataset seeded with
    SEED: the batches and the host seconds per batch."""
    from generative_audio_torch.data import (
        BatchLoader, DNSTrainConfig, DNSTrainDataset)
    from generative_audio_torch.utils.config import build_dataclass
    loader = BatchLoader(DNSTrainDataset(build_dataclass(
        DNSTrainConfig, config), seed=SEED), CORPUS_BATCH, seed=SEED,
        num_workers=workers)
    t0 = time.perf_counter()
    batches = list(loader)
    return batches, (time.perf_counter() - t0) / len(batches)


def phase_corpus_training(dev):
    """Phase 15: FullSubNet+ trained from a corpus on disk through
    generative_audio_torch.cli.train (two epochs, then one more with -R),
    then cli.validate on the best checkpoint. Returns the launches of the
    CLI runs by kernel."""
    from generative_audio_torch.cli import train as train_cli
    from generative_audio_torch.cli import validate as validate_cli
    from generative_audio_torch.data import (
        BatchLoader, DNSTrainConfig, DNSTrainDataset, LoopIterator,
        load_audio, native)
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.utils.config import build_dataclass
    card = card_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _hidden_module("soundfile"):
        root = Path(tmp)
        data, validation, clean_dir, noise_dir, flac_pairs = \
            _write_corpus(root)
        log(f"corpus: {CORPUS_CLEAN} clean clips and {CORPUS_NOISE} noise "
            f"clips of {CORPUS_SECONDS} s ({CORPUS_FLAC} clean clips as FLAC "
            f"in the clean scp), {CORPUS_RIRS} RIRs, V {CORPUS_VAL} x "
            f"{CORPUS_VAL_SECONDS} s, P {CORPUS_PROBE} x "
            f"{CORPUS_PROBE_SECONDS} s: written in "
            f"{time.perf_counter() - t_phase:.2f} s")

        # FLAC through the native decoder, built at its first use (main
        # removed a library carried over from another machine)
        check(native._lib is None and not native._LIB.exists(),
              "the native library is neither built nor loaded yet")
        t0 = time.perf_counter()
        worst = 0.0
        for flac, wav in flac_pairs:
            got = load_audio(flac)
            want = load_audio(wav)
            check(got.shape == want.shape, f"{flac.name}: length of the WAV")
            worst = max(worst, float(np.abs(got - want).max()))
        check(native._lib is not None and native._LIB.exists(),
              "the FLAC clips decoded through the native binding, built at "
              f"first use into {native._LIB.parent}")
        check(worst <= 1 / 32768, f"FLAC == WAV within one int16 step "
              f"(max |diff| {worst:.3e})")
        log(f"corpus: {CORPUS_FLAC} FLAC clips decoded by the native binding "
            f"(soundfile hidden), built at first use in "
            f"{time.perf_counter() - t0:.2f} s; max |FLAC - WAV| {worst!r}")

        # the loader: the same batches at 1 and 24 workers, its host time
        passes = {w: _loader_pass(data, w) for w in (1, CORPUS_WORKERS, 1)}
        one, many = passes[1][0], passes[CORPUS_WORKERS][0]
        check(len(one) == len(many) == CORPUS_CLEAN // CORPUS_BATCH and all(
            np.array_equal(a, b) for x, y in zip(one, many)
            for a, b in zip(x, y)),
            f"two loader passes with seed {SEED} give identical batches at 1 "
            f"and {CORPUS_WORKERS} workers")
        dataset = DNSTrainDataset(build_dataclass(DNSTrainConfig, data),
                                  seed=SEED)
        dataset.set_epoch(1)
        t0 = time.perf_counter()
        for i in range(len(dataset)):
            dataset[i]
        mix_ms = (time.perf_counter() - t0) * 1e3 / len(dataset)
        log(f"loader: host time per batch of {CORPUS_BATCH} (3.072 s clips, "
            f"RIR at 0.75): {passes[1][1] * 1e3:.2f} ms at 1 worker, "
            f"{passes[CORPUS_WORKERS][1] * 1e3:.2f} ms at {CORPUS_WORKERS}; "
            f"mixing {mix_ms:.3f} ms per clip, serial")

        # training through the CLI: two epochs, then one more with -R
        cfg_path = _train_config(root, data, validation)
        steps, validations, restores = [], [], []
        L.reset_launch_counts()
        t0 = time.perf_counter()
        with _instrumented_trainer(steps, validations, restores):
            first = train_cli.main(["-C", str(cfg_path), "--epochs",
                                    str(CORPUS_EPOCHS)])
            first_s = time.perf_counter() - t0
            ckpt = root / "ckpt"
            latest = torch.load(ckpt / "latest.pt", map_location="cpu",
                                weights_only=True)
            meta = json.loads((ckpt / "best_score.json").read_text())
            n_first = len(steps)
            del first
            t0 = time.perf_counter()
            second = train_cli.main(["-C", str(cfg_path), "-R", "--epochs",
                                     "1"])
            second_s = time.perf_counter() - t0
        per_epoch = CORPUS_CLEAN // CORPUS_BATCH
        n_chunks = _chunks(int(CORPUS_VAL_SECONDS * 16000) // 256 + 3, 257,
                           HIDDEN, VAL_GATES_LIMIT)
        corpus_rows = CORPUS_BATCH * TRAIN_ROWS // TRAIN_BATCH
        per_step = routed_step({"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2},
                               corpus_rows)
        # each clip alone: 257 sub-band rows, as the route takes them
        per_val = routed_counts(("lstm_scan_fwd_carry", ROWS // 8,
                                 2 * n_chunks * CORPUS_VAL))
        per_probe = routed_counts(("lstm_scan_fwd", ROWS // 8,
                                   2 * CORPUS_PROBE))
        log(f"train CLI: steps {[(r['step'], round(r['loss'], 5)) for r in steps]}"
            f"; validations {[(n, d) for n, d, _ in validations]}; restore "
            f"{restores}; best_score.json {meta}")
        check(len(steps) == 3 * per_epoch and n_first == 2 * per_epoch,
              f"the CLI took {per_epoch} steps an epoch ({len(steps)} steps)")
        check(all(r["launched"] == per_step
                  and r["rows"] == (CORPUS_BATCH, 49152) for r in steps),
              f"every step launched {per_step} and nothing else, on a batch "
              f"of {CORPUS_BATCH} x 49152")
        check([(n, d) for n, d, _ in validations]
              == [(CORPUS_VAL, per_val), (CORPUS_PROBE, per_probe)] * 3,
              f"each validation of V launched {per_val} (6 s clips in "
              f"{n_chunks} chunks a layer) and of P {per_probe}")
        check(all(np.isfinite(r["loss"]) for r in steps)
              and np.isfinite(second.loss_history).all(),
              "finite losses")
        check(meta["probe_weight"] == 0.5 and latest["step"] == n_first
              and latest["best_score"] == meta["score"],
              "best_score.json records probe weight 0.5; latest.pt holds "
              "its score")
        check(restores == [(True, n_first, latest["best_score"])]
              and steps[n_first]["step"] == n_first + 1
              and second.state.step == 3 * per_epoch,
              "-R resumed at the saved step with the saved best score, and "
              "its first step continued the count")

        # the best checkpoint through the validate CLI, over an AudioDataset
        # of the same corpus
        vcfg = root / "validate.json"
        model = {k: v for k, v in CORPUS_MODEL.items()
                 if k != "num_groups_in_drop_band"}
        vcfg.write_text(json.dumps({"model": model, "data": {
            "clean_path": str(clean_dir), "noisy_path": str(noise_dir)}}))
        vbefore = dict(L.launch_counts)
        t0 = time.perf_counter()
        means = validate_cli.main([
            "-C", str(vcfg), "-M", str(ckpt), "-O",
            str(root / "validation_results.json"), "--max_items",
            str(CORPUS_VALIDATE_ITEMS)])
        validate_s = time.perf_counter() - t0
        written = json.loads((root / "validation_results.json").read_text())
        vlaunched = {k: v - vbefore[k] for k, v in L.launch_counts.items()
                     if v != vbefore[k]}
        check(vlaunched == routed_counts(("lstm_scan_fwd", ROWS // 8,
                                          2 * CORPUS_VALIDATE_ITEMS)),
              f"the validate CLI launched kernel A twice a clip "
              f"({vlaunched})")
        check(written == means and all(
            means[k] is not None and np.isfinite(means[k])
            for k in ("STOI", "SI_SDR")),
            f"validation_results.json with finite STOI and SI_SDR ({means})")
        launched = {k: v for k, v in L.launch_counts.items() if v}
        want = routed_counts(
            ("lstm_scan_fwd_train", corpus_rows, 2 * len(steps)),
            ("lstm_scan_bwd", corpus_rows, 2 * len(steps)),
            ("lstm_scan_fwd_carry", ROWS // 8, 3 * 2 * n_chunks * CORPUS_VAL),
            ("lstm_scan_fwd", ROWS // 8,
             3 * 2 * CORPUS_PROBE + 2 * CORPUS_VALIDATE_ITEMS))
        check(launched == want,
              f"phase 15 launched {want} and nothing else (got {launched})")
        log(f"validate CLI: {CORPUS_VALIDATE_ITEMS} clips of 3 s, "
            f"{validate_s:.2f} s; validation_results.json means {means}")

        # readings: the step through the CLI's loader (an epoch's second
        # step: from the end of the first to its own end, so that it holds
        # the wait for the loader's batch) beside phase 6's in-memory step
        later = [i for i in range(len(steps)) if i % per_epoch]
        step_ms = statistics.median(
            (steps[i]["end"] - steps[i - 1]["end"]) * 1e3 for i in later)
        wait_ms = statistics.median(
            (steps[i]["start"] - steps[i - 1]["end"]) * 1e3 for i in later)
        first_ms = [(r["end"] - r["start"]) * 1e3
                    for i, r in enumerate(steps) if not i % per_epoch]
        in_memory = STEP_MS["FullSubNet+"]
        log(f"train CLI: {CORPUS_EPOCHS} epochs in {first_s:.2f} s, resumed "
            f"epoch in {second_s:.2f} s; ms per step after an epoch's first "
            f"(median of {len(later)}) {step_ms:.2f}, of which "
            f"{wait_ms:.2f} waiting for the loader = "
            f"{CORPUS_BATCH / step_ms * 1e3:.2f} clips/s; an epoch's first "
            f"step from its batch's arrival "
            f"{' '.join(f'{x:.1f}' for x in first_ms)} ms; phase 6's step "
            f"from an in-memory batch {in_memory:.2f} ms "
            f"({100 * (step_ms / in_memory - 1):+.1f}%); on {card}")

        # where a loader-fed step's time goes, with the loader's threads at
        # work on the next batches; then the same trainer's step fed by the
        # loader (taking a batch submits the next one, whose mixing runs
        # during the step) and from a batch in memory with the workers
        # idle, in alternating rounds, each after a pause that lets the
        # workers finish
        loader = BatchLoader(dataset, CORPUS_BATCH, seed=SEED,
                             num_workers=CORPUS_WORKERS)
        batches = iter(LoopIterator(loader, n_steps=3 + CORPUS_AB_ROUNDS))
        fed, held = [], []
        try:
            _profile(lambda: second.train_epoch([next(batches)]),
                     f"FullSubNet+ training step fed by the loader "
                     f"({CORPUS_WORKERS} workers)")
            in_memory_batch = next(batches)
            for _ in range(CORPUS_AB_ROUNDS):
                for times, take in ((fed, lambda: next(batches)),
                                    (held, lambda: in_memory_batch)):
                    time.sleep(CORPUS_AB_PAUSE)
                    t0 = time.perf_counter()
                    second.train_epoch([take()])          # ends in a fetch
                    times.append((time.perf_counter() - t0) * 1e3)
        finally:
            batches.close()
        fed_ms, held_ms = statistics.median(fed), statistics.median(held)
        log(f"train step A/B, {CORPUS_AB_ROUNDS} alternating rounds: fed by "
            f"the loader ({CORPUS_WORKERS} workers mixing the next batch) "
            f"{' '.join(f'{x:.1f}' for x in fed)} ms, median {fed_ms:.2f}; "
            f"from a batch in memory, workers idle "
            f"{' '.join(f'{x:.1f}' for x in held)} ms, median {held_ms:.2f} "
            f"({100 * (fed_ms / held_ms - 1):+.1f}%); on {card}")
        del second
    log(f"phase 15: {time.perf_counter() - t_phase:.2f} s")
    return {k: v for k, v in launched.items()
            if k in (*AB_ENTRIES, *C_ENTRIES, *D_ENTRIES)}


# Phase 16: the denoising-NPPC line at full width, bf16:
# scripts/denoising_nppc_e2e.py's configuration (the frozen enhancer
# FullSubNetPlusConfig(num_groups_in_drop_band=1), the head
# MultiDirectionConfig(n_directions=5, num_groups_in_drop_band=2), STFT
# 512/256/512) and configs/denoising_nppc.yaml's optimizer (lr 1e-4, lambda
# 0.1, grace 200).
NPPC_ENHANCER = {"num_groups_in_drop_band": 1}
NPPC_HEAD = {"n_directions": 5, "num_groups_in_drop_band": 2}
NPPC_BATCH, NPPC_SAMPLES, NPPC_STEPS = 8, 49152, 5
# the head's sub-band rows of a step: 128 of the 257 bins a clip (drop_band
# of 2 groups), over which its scans run
NPPC_HEAD_ROWS = NPPC_BATCH * TRAIN_ROWS // TRAIN_BATCH
NPPC_REF_BATCH, NPPC_REF_SAMPLES = 4, 16000
NPPC_VAL_SECONDS, NPPC_VAL_SNR = 6.0, 5.0
# configs/denoising_nppc.yaml's train: block, as JSON (the card's machine
# has no PyYAML); its model is the config's default, so the head trains
# without drop_band there
NPPC_CLI_TRAIN = {"n_dirs": 5, "learning_rate": 0.0001,
                  "second_moment_loss_lambda": 0.1,
                  "second_moment_loss_grace": 200}
NPPC_CLI_CLEAN, NPPC_CLI_NOISE, NPPC_CLI_SECONDS = 16, 4, 4.0
NPPC_CLI_WORKERS, NPPC_CLI_STEPS = 8, 2
# Gram-Schmidt runs in float32 on the card: the largest |<w_i, w_j>| of two
# unit directions of one clip (D = 2 x 257 x 63 elements)
NPPC_ORTHO_ABS = 1e-4
# The seeds of random_denoising_nppc_params at which the head alone runs in
# bf16 on the card over the float32 enhancer's streams. The end-to-end
# check above holds only where each offline_laplace_norm divisor (the
# stream's signed mean + 1e-5) keeps its sign between bf16 and float32; at
# seeds 0 and 31 the enhanced real stream's divisor flips (ROADMAP.md,
# reference quirks), so the head's own check takes them.
NPPC_HEAD_SEEDS = (0, 7, 20, 31, 40)


def nppc_config():
    from generative_audio_torch.models import (
        DenoisingNPPCConfig, FullSubNetPlusConfig, MultiDirectionConfig,
        StftConfig)
    return DenoisingNPPCConfig(
        restoration=FullSubNetPlusConfig(**NPPC_ENHANCER),
        pc_wrapper=MultiDirectionConfig(**NPPC_HEAD),
        stft=StftConfig(512, 256, 512))


def _nppc_train_config(cfg):
    from generative_audio_torch.train import NPPCDenoisingTrainConfig
    return NPPCDenoisingTrainConfig(
        model=cfg, learning_rate=NPPC_CLI_TRAIN["learning_rate"],
        second_moment_loss_lambda=NPPC_CLI_TRAIN["second_moment_loss_lambda"],
        second_moment_loss_grace=NPPC_CLI_TRAIN["second_moment_loss_grace"])


def _nppc_trainer(cfg, params, device, dtype, checkpoint_dir=None):
    """NPPCDenoisingTrainer with the enhancer and the head from `params`
    (the JAX layout)."""
    from generative_audio_torch.train import NPPCDenoisingTrainer
    from generative_audio_torch.utils import convert
    trainer = NPPCDenoisingTrainer(
        _nppc_train_config(cfg),
        restoration_params=params["pretrained_restoration_model"],
        checkpoint_dir=checkpoint_dir, seed=SEED, device=device,
        compute_dtype=dtype)
    trainer.state.model.audio_pc_wrapper.net.load_state_dict(
        convert.convert_multidirection(params["audio_pc_wrapper"]["net"]))
    return trainer


def _log_divisors(divisors):
    for what, calls in divisors.items():
        names = HEAD_NORMS if what.startswith("head") else ENHANCER_NORMS
        log(f"  {what} norm divisors (signed mean + 1e-5): " + "; ".join(
            f"{name} " + " ".join(f"{d:+.3e}" for d in c)
            for name, c in zip(names, calls)))


def _nppc_model_check(dev, cfg, sd, counts):
    """A 1 s clip through forward_with_pred_crm, the card (bf16) against the
    float32 model on the CPU, and the card's directions orthogonal; each
    norm call's divisor on both sides."""
    from generative_audio_torch.models import DenoisingNPPCModel
    card_model = DenoisingNPPCModel(cfg, compute_dtype=torch.bfloat16,
                                    device=dev)
    card_model.load_state_dict(sd)
    cpu_model = DenoisingNPPCModel(cfg, compute_dtype=torch.float32,
                                   device="cpu")
    cpu_model.load_state_dict(sd)
    wav = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (1, 16000)).astype(np.float32) * 0.1)
    before = dict(counts)
    divisors = {}
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        for side, model in (("card, bf16", card_model),
                            ("CPU, float32", cpu_model)):
            stack.enter_context(_divisors(model.pretrained_restoration_model,
                                          divisors, f"enhancer, {side}"))
            stack.enter_context(_divisors(model.audio_pc_wrapper.net,
                                          divisors, f"head, {side}"))
        w_card, crm_card = card_model.forward_with_pred_crm(wav.to(dev))
        w_card, crm_card = w_card.cpu(), crm_card.cpu()
        w_cpu, crm_cpu = cpu_model.forward_with_pred_crm(wav)
    launched = _launched(counts, before)
    a_entry = routed("lstm_scan_fwd", ROWS // 8)
    check(launched == {a_entry: 4},
          f"a 1 s forward launched 2 {a_entry} (the route's at 257 rows) for "
          f"the enhancer and 2 for the head, nothing else (got {launched})")
    check(w_card.dtype == torch.float32 and torch.isfinite(w_card).all()
          and w_card.shape == w_cpu.shape, "w_mat float32, finite, shaped")
    rel_w = ((w_card - w_cpu).abs().max() / w_cpu.abs().max()).item()
    rel_c = ((crm_card - crm_cpu).abs().max() / crm_cpu.abs().max()).item()
    w = w_card.double()
    z = torch.complex(w[:, :, 0], w[:, :, 1]).flatten(2)[0]       # [K, D]
    unit = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    gram = (unit.conj() @ unit.T).abs()
    off = (gram - torch.diag(torch.diagonal(gram))).max().item()
    log(f"nppc model: 1 s clip, w_mat {tuple(w_card.shape)}: card (bf16) vs "
        f"CPU (float32) max|err|/peak w_mat {rel_w:.3e}, cRM {rel_c:.3e}; "
        f"largest |<w_i, w_j>| of the card's unit directions {off:.3e}; "
        f"launches {launched}")
    _log_divisors(divisors)
    check(rel_w < PATH_REL and rel_c < PATH_REL,
          f"nppc forward card vs CPU within {PATH_REL} of the peak")
    check(off < NPPC_ORTHO_ABS,
          f"the card's directions orthogonal within {NPPC_ORTHO_ABS}")
    return card_model, cpu_model, launched


# the streams an offline_laplace_norm call takes, in call order
ENHANCER_NORMS = ("noisy mag", "noisy real", "noisy imag", "sub-band input")
HEAD_NORMS = ("noisy mag", "enhanced mag", "noisy real", "enhanced real",
              "noisy imag", "enhanced imag", "sub-band input")


def _divisors(module, record, what):
    """While open, module.norm (offline_laplace_norm) records under `what`
    each call's divisor per item: the signed mean over (C, F, T) + 1e-5."""
    norm = module.norm

    def recorded(x):
        record.setdefault(what, []).append(
            (x.float().mean(dim=(1, 2, 3)) + 1e-5).cpu().tolist())
        return norm(x)

    return mock.patch.object(module, "norm", recorded)


def _nppc_head_seeds(dev, cfg, counts):
    """For each seed of NPPC_HEAD_SEEDS: the float32 enhancer's six streams
    of a 1 s clip on the CPU, the head (MultiDirectionFullSubNetPlus) over
    them in bf16 on the card against float32 on the CPU, within PATH_REL of
    the peak; every norm call's divisors printed. Returns the launches."""
    from generative_audio_torch.models import (
        DenoisingNPPCModel, MultiDirectionFullSubNetPlus)
    from generative_audio_torch.ops.mask import (
        crm_to_stft_components, decompress_cIRM)
    from generative_audio_torch.utils import convert
    wav = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (1, 16000)).astype(np.float32) * 0.1)
    before = dict(counts)
    worst = 0.0
    for seed in NPPC_HEAD_SEEDS:
        sd = convert.convert_denoising_nppc(
            convert.random_denoising_nppc_params(cfg, seed=seed))
        cpu = DenoisingNPPCModel(cfg, compute_dtype=torch.float32,
                                 device="cpu")
        cpu.load_state_dict(sd)
        head = MultiDirectionFullSubNetPlus(
            cfg.pc_wrapper, compute_dtype=torch.bfloat16, device=dev)
        head.load_state_dict({k[len("audio_pc_wrapper.net."):]: v for k, v in
                              sd.items()
                              if k.startswith("audio_pc_wrapper.net.")})
        divisors = {}
        with torch.inference_mode(), \
                _divisors(cpu.pretrained_restoration_model, divisors,
                          "enhancer"), \
                _divisors(cpu.audio_pc_wrapper.net, divisors, "head, CPU"), \
                _divisors(head, divisors, "head, card"):
            mag, real, imag = cpu._stft_triplet(wav)
            crm = decompress_cIRM(cpu._enhancer(mag, real, imag).permute(
                0, 2, 3, 1))
            enhanced = [x[:, None] for x in crm_to_stft_components(
                crm, real[:, 0], imag[:, 0])]
            streams = [mag, real, imag] + enhanced
            want = cpu.audio_pc_wrapper.net(*streams)
            got = head(*(x.to(dev) for x in streams)).float().cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        worst = max(worst, rel)
        log(f"nppc head, seed {seed}: bf16 on the card over the float32 "
            f"enhancer's streams vs float32 on the CPU, max|err|/peak "
            f"{rel:.3e}")
        _log_divisors(divisors)
        check(torch.isfinite(got).all() and got.shape == want.shape,
              f"the head's output finite and shaped (seed {seed})")
        check(rel < PATH_REL, f"the bf16 head within {PATH_REL} of the "
              f"float32 head at seed {seed}")
    launched = _launched(counts, before)
    log(f"nppc head over {len(NPPC_HEAD_SEEDS)} seeds: worst {worst:.3e}; "
        f"launches {launched}")
    want = routed_counts(("lstm_scan_fwd", ROWS // 8,
                          2 * len(NPPC_HEAD_SEEDS)))
    check(launched == want,
          f"each seed's head forward launched 2 of kernel A (the route's at "
          f"257 rows), nothing else (got {launched})")
    return launched


@contextlib.contextmanager
def _recorded_calls(module, **entries):
    """While open, records every call of the functions of `module` that
    `entries` names ({key: function name}): under each key, in call order,
    the call's arguments (in the signature's order, defaults filled in) and
    its result. Every tensor is a copy: an operand may be a view of a
    parameter that the optimizer updates in place after the step."""
    calls = {key: [] for key in entries}

    def copied(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        return tuple(map(copied, x)) if isinstance(x, tuple) else x

    def recorder(key, fn):
        signature = inspect.signature(fn)

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            calls[key].append((copied(tuple(bound.arguments.values())),
                               copied(out)))
            return out
        return recorded

    with contextlib.ExitStack() as stack:
        for key, name in entries.items():
            stack.enter_context(mock.patch.object(
                module, name, recorder(key, getattr(module, name))))
        yield calls


def _recorded_scans(L):
    """_recorded_calls of ops.lstm's lstm_scan_train_tm (kernel C) and
    lstm_scan_bwd_tm (kernel D), the two LSTMScan makes, under "C" and
    "D"."""
    return _recorded_calls(L, C="lstm_scan_train_tm", D="lstm_scan_bwd_tm")


def _scans_vs_plain(L, dev, calls, what, n):
    """Kernels C and D on the very operands `what`'s n LSTMScan layers
    handed them in a training step (as _recorded_scans records them),
    against their plain versions on the card under phase 3's limits. The
    same limits must reject each kernel's result with its rows rolled by
    one cluster (a cluster writing its neighbour's rows). Each result is
    also the same bit for bit under another plan: kernel C's rows within
    the operands tiled to phase 3's TRAIN_ROWS, kernel D's as the
    single-block design gives them."""
    check(len(calls["C"]) == n and len(calls["D"]) == n,
          f"{what}: the step made {n} kernel C and {n} kernel D calls (got "
          f"{len(calls['C'])} and {len(calls['D'])})")
    for i, ((gates, w_hh, reverse), (h_seq, c_seq)) in enumerate(calls["C"]):
        t_len, rows, h = h_seq.shape
        hp = L.scan_hidden(h)           # the H the wrapper pads the layer to
        shift = L.card_scan_plan(dev, hp, rows, train=True).rows % rows or 1
        p_h, p_c = L.lstm_scan_train_reference_tm(gates, w_hh, reverse)
        peak_c = p_c.float().abs().max().item()
        # phase 3's c limits hold at its peak |c| of about 2.5; a bf16 step
        # of c grows with |c|, so they grow with the peak above that
        scale = max(1.0, peak_c / C_PEAK)

        def within(got_h, got_c):
            err_h = (got_h.float() - p_h.float()).abs()
            err_c = (got_c.float() - p_c.float()).abs()
            return (err_h.max().item(), err_c.max().item(),
                    err_c.mean().item(),
                    err_h.max().item() < 8 * KERNEL_MAX_ABS
                    and err_c.max().item() < 8 * KERNEL_MAX_ABS * scale
                    and err_c.mean().item() < 8 * KERNEL_MEAN_ABS * scale)
        max_h, max_c, mean_c, ok = within(h_seq, c_seq)
        faulty = within(h_seq.roll(shift, 1), c_seq.roll(shift, 1))
        log(f"kernel C on {what}, call {i + 1} (T={t_len} rows={rows} H={h}, "
            f"reverse={reverse}, plan "
            f"{_plan_line(L, dev, hp, rows, train=True)}): h max|err| "
            f"{max_h:.3e}, c max|err| {max_c:.3e} mean {mean_c:.3e} (peak |h| "
            f"{p_h.float().abs().max().item():.3f}, |c| {peak_c:.3f}); rows "
            f"rolled by {shift}: h {faulty[0]:.3e}, c {faulty[1]:.3e} mean "
            f"{faulty[2]:.3e}")
        check(ok, f"kernel C vs plain on {what}, call {i + 1} within "
              f"{8 * KERNEL_MAX_ABS} (h), {8 * KERNEL_MAX_ABS * scale}/"
              f"{8 * KERNEL_MEAN_ABS * scale} (c)")
        check(not faulty[3], f"the kernel C limits reject rows rolled by "
              f"{shift} ({what}, call {i + 1})")
        tiled = gates.repeat(1, -(-TRAIN_ROWS // rows), 1)[:, :TRAIN_ROWS]
        h_t, c_t = L.lstm_scan_train_tm(tiled.contiguous(), w_hh, reverse)
        check(all(torch.equal(h_t[:, k:k + rows], h_seq)
                  and torch.equal(c_t[:, k:k + rows], c_seq)
                  for k in range(0, TRAIN_ROWS - rows + 1, rows)),
              f"kernel C on {what}'s call {i + 1} == its rows within "
              f"{TRAIN_ROWS} tiled rows bitwise")
        log(f"  == its rows within {TRAIN_ROWS} tiled rows bitwise (plan "
            f"{_plan_line(L, dev, hp, TRAIN_ROWS, train=True)})")
        del tiled, h_t, c_t
    for i, ((gates, h_seq, c_seq, gout, w_hh, reverse, _), dg) in enumerate(
            calls["D"]):
        t_len, rows, h = h_seq.shape
        shift = L.card_bwd_scan_plan(dev, h, rows).rows % rows or 1
        want = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh,
                                            reverse).float()
        peak = want.abs().max().item()

        def within(got):
            err = (got.float() - want).abs()
            return (err.max().item(), err.mean().item(),
                    err.max().item() < BWD_MAX_REL * peak
                    and err.mean().item() < BWD_MEAN_REL * peak)
        max_d, mean_d, ok = within(dg)
        faulty = within(dg.roll(shift, 1))
        log(f"kernel D on {what}, call {i + 1} (T={t_len} rows={rows} H={h}, "
            f"reverse={reverse}, plan {_bwd_plan_line(L, dev, h, rows)}): "
            f"dgates max|err| {max_d:.3e} mean {mean_d:.3e} (peak {peak:.3e}); "
            f"rows rolled by {shift}: max {faulty[0]:.3e} mean "
            f"{faulty[1]:.3e}")
        check(peak > 0 and ok, f"kernel D vs plain on {what}, call {i + 1} "
              f"within {BWD_MAX_REL}/{BWD_MEAN_REL} of the peak")
        check(not faulty[2], f"the kernel D limits reject rows rolled by "
              f"{shift} ({what}, call {i + 1})")
        block = L.lstm_scan_bwd_planned_tm(gates, h_seq, c_seq, gout, w_hh,
                                           _block_bwd_plan(L, dev, h, rows),
                                           reverse)
        check(torch.equal(block, dg), f"kernel D on {what}'s call {i + 1} "
              f"== the single block bitwise")
        log("  == the single block bitwise")


def _nppc_training(dev, cfg, params, counts):
    """Five steps of NPPCDenoisingTrainer on one seeded batch, step 1 with
    kernels C and D held on their operands against the plain versions
    (those launches left out of the count). Returns the trainer, the batch
    and the steps' launches."""
    from generative_audio_torch.ops import lstm as L
    trainer = _nppc_trainer(cfg, params, dev, torch.bfloat16)
    model = trainer.state.model
    enhancer = model.pretrained_restoration_model
    frozen = {k: v.clone() for k, v in enhancer.state_dict().items()}
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 22, NPPC_BATCH, NPPC_SAMPLES))
    verify_grads = _first_grads(model.audio_pc_wrapper.named_parameters(),
                                "head")
    # the frozen enhancer's forward over the batch's sub-band rows, as the
    # route takes them
    per_step = routed_counts(("lstm_scan_fwd", NPPC_BATCH * ROWS // 8, 2),
                             ("lstm_scan_fwd_train", NPPC_HEAD_ROWS, 2),
                             ("lstm_scan_bwd", NPPC_HEAD_ROWS, 2))
    torch.cuda.reset_peak_memory_stats(dev)
    objectives, reconst, times = [], [], []
    total = dict.fromkeys(per_step, 0)
    for step in range(NPPC_STEPS):
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (_recorded_scans(L) if step == 0 else
              contextlib.nullcontext()) as recorded:
            obj, rec = trainer.train_step(noisy, clean)
        objectives.append(obj.item())                        # a fetch
        times.append((time.perf_counter() - t0) * 1e3)
        reconst.append(rec.item())
        launched = _launched(counts, before)
        check(launched == per_step,
              f"nppc train step {step + 1} launched {per_step} and nothing "
              f"else (got {launched})")
        total = {k: total[k] + n for k, n in launched.items()}
        if step == 0:
            verify_grads()
            _scans_vs_plain(L, dev, recorded, "the nppc head's layers", 2)
            del recorded
            # the records held the operands past the step: steps 2-5 give
            # the peak
            torch.cuda.reset_peak_memory_stats(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(np.isfinite(objectives).all() and np.isfinite(reconst).all(),
          "nppc objectives finite")
    check(trainer.state.step == NPPC_STEPS, "five optimizer steps counted")
    check(all(torch.equal(v, frozen[k])
              for k, v in enhancer.state_dict().items())
          and all(p.grad is None for p in enhancer.parameters()),
          "the frozen enhancer bit for bit unchanged, with no gradient")
    steady = statistics.median(times[1:])
    STEP_MS["nppc"] = steady
    log(f"train nppc: batch {NPPC_BATCH} x {NPPC_SAMPLES / 16000:.3f} s, "
        f"{cfg.pc_wrapper.n_directions} directions, bf16: objectives "
        f"{' '.join(f'{x:.6f}' for x in objectives)}, reconst_err "
        f"{' '.join(f'{x:.6f}' for x in reconst)}; the enhancer unchanged")
    log(f"train nppc: ms per step {' '.join(f'{x:.1f}' for x in times)}; "
        f"median of steps 2-{NPPC_STEPS} {steady:.2f} ms = "
        f"{NPPC_BATCH / steady * 1e3:.2f} clips/s; peak memory of steps "
        f"2-{NPPC_STEPS} {peak:.2f} GiB on {card_line()}")
    return trainer, (noisy, clean), total


def _nppc_reference(dev, cfg, params, dtype=torch.bfloat16):
    """A 4 x 1 s batch: the objective, reconst_err and the head's gradients
    on the card in `dtype` (bf16, or float32 on the recurrent layers' mixed
    route) against the float32 trainer on the CPU, at the step where lambda
    reaches its scale (both terms of the objective)."""
    import torch.nn.functional as F
    noisy, clean = (torch.from_numpy(x) for x in
                    _noise_batch(SEED + 23, NPPC_REF_BATCH, NPPC_REF_SAMPLES))
    step = NPPC_CLI_TRAIN["second_moment_loss_grace"]
    mode = "bf16" if dtype == torch.bfloat16 else "float32 (mixed)"
    out = {}
    for name, device, dtype in (("card", dev, dtype),
                                ("cpu", "cpu", torch.float32)):
        trainer = _nppc_trainer(cfg, params, device, dtype)
        obj, rec, _ = trainer.objective(noisy.to(device), clean.to(device),
                                        step)
        obj.backward()
        out[name] = (obj.item(), rec.mean().item(), {
            k: p.grad.float().cpu() for k, p in
            trainer.state.model.audio_pc_wrapper.named_parameters()})
    rel_obj = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rel_rec = abs(out["card"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    top = max(g.norm().item() for g in out["cpu"][2].values())
    rows = []
    for k, want in out["cpu"][2].items():
        got = out["card"][2][k]
        cos = F.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
        rows.append((cos, got.norm().item() / max(want.norm().item(), 1e-30),
                     want.norm().item() / top, k))
    carrying = [r for r in rows if r[2] > 1e-3]
    worst = min(carrying)
    ratios = [r[1] for r in carrying]
    log(f"nppc reference: {NPPC_REF_BATCH} x {NPPC_REF_SAMPLES / 16000:.0f} s "
        f"at step {step}, {mode} on the card vs float32 on the CPU: objective "
        f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel {rel_obj:.3e}), "
        f"reconst_err {out['card'][1]:.7f} vs {out['cpu'][1]:.7f} (rel "
        f"{rel_rec:.3e}); of {len(rows)} head tensors {len(carrying)} carry "
        f"the gradient: lowest cosine {worst[0]:.5f} ({worst[3]}), norm "
        f"ratios {min(ratios):.4f}-{max(ratios):.4f}")
    # the sub-band LSTM's tensors: their gradients come from kernel D
    scan = [r for r in rows if ".sb_model.sequence_model." in r[3]]
    for cos, ratio, share, k in scan:
        log(f"  {k}: cosine {cos:.5f}, norm ratio {ratio:.4f}, "
            f"norm/largest {share:.2e}")
    check(len(scan) == 8 and all(r in carrying for r in scan),
          f"the sub-band LSTM's 8 tensors carry the gradient (got "
          f"{[(r[3], r[2]) for r in scan]})")
    check(rel_obj < NPPC_OBJ_REL and rel_rec < NPPC_OBJ_REL,
          f"{mode} objective and reconst_err vs float32 within "
          f"{NPPC_OBJ_REL}")
    check(worst[0] > NPPC_GRAD_COS
          and all(abs(r - 1) < NPPC_GRAD_RATIO for r in ratios),
          f"{mode} head gradients vs float32: cosine above {NPPC_GRAD_COS}, "
          f"norms within {NPPC_GRAD_RATIO}")


def _nppc_validation(dev, card_model, cpu_model, counts):
    """DenoisingNPPCValidator on a 6 s clip with its clean reference, the
    model's LSTM layers under VAL_GATES_LIMIT (kernel B): the files, the
    figure's size, the variations against the CPU's float32 model, and the
    wall time per sample."""
    from generative_audio_torch.data import read_wav
    from generative_audio_torch.eval import (
        DenoisingNPPCValidator, DenoisingNPPCValidatorConfig)
    from generative_audio_torch.eval.nppc_denoising_validator import (
        figure_size)
    from generative_audio_torch.nn.recurrent import LSTMLayer
    noisy, clean = _speech_pair(SEED + 24, NPPC_VAL_SECONDS, NPPC_VAL_SNR)
    frames = len(noisy) // 256 + 1
    n_chunks = _chunks(frames + 2, 257, HIDDEN, VAL_GATES_LIMIT)
    expected = routed_counts(("lstm_scan_fwd_carry", ROWS // 8,
                              2 * 2 * n_chunks))
    layers = {m: m.gates_bytes_limit for m in card_model.modules()
              if isinstance(m, LSTMLayer)}
    for layer in layers:
        layer.gates_bytes_limit = VAL_GATES_LIMIT
    n_dirs = card_model.config.pc_wrapper.n_directions
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        walls = []
        launched = None
        for name, model, device, runs in (
                ("card", card_model, dev, 2), ("cpu", cpu_model, "cpu", 1)):
            val = DenoisingNPPCValidator(
                model.forward_with_pred_crm, None,
                DenoisingNPPCValidatorConfig(save_dir=str(Path(tmp) / name)),
                device=device)
            for i in range(runs):
                before = dict(counts)
                t0 = time.perf_counter()
                out = val.validate_sample(noisy, clean_waveform=clean,
                                          sample_idx=i)
                if name == "card":
                    walls.append(time.perf_counter() - t0)
                    got = _launched(counts, before)
                    check(got == expected,
                          f"the validator's {NPPC_VAL_SECONDS} s clip launched "
                          f"{expected} ({n_chunks} chunks a layer, enhancer "
                          f"and head), nothing else (got {got})")
                    launched = {k: (launched or {}).get(k, 0) + v
                                for k, v in got.items()}
            dirs[name] = Path(out["save_dir"])
        files = sorted(p.name for p in dirs["card"].iterdir())
        wavs = [f for f in files if f.startswith("pc") and f.endswith(".wav")]
        check(len(wavs) == n_dirs * 6 and {"enhanced.wav", "noisy.wav",
                                            "clean.wav"} <= set(files),
              f"{n_dirs} x 6 variation wavs and enhanced, noisy, clean "
              f"({files})")
        png = (dirs["card"] / "pc_spectrograms_variations.png").read_bytes()
        size = struct.unpack(">II", png[16:24])
        want_size = figure_size(n_dirs, 6, 257, frames)
        check(png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
              and size == want_size,
              f"the figure is a PNG of {want_size} pixels (got {size})")
        worst = 0.0
        for f in wavs + ["enhanced.wav"]:
            a = read_wav(dirs["card"] / f)[1]
            b = read_wav(dirs["cpu"] / f)[1]
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    for layer, own in layers.items():
        layer.gates_bytes_limit = own
    log(f"nppc validator: {NPPC_VAL_SECONDS} s clip, gates limit "
        f"{VAL_GATES_LIMIT >> 20} MiB ({n_chunks} chunks a layer): launches "
        f"a sample {expected}; {len(wavs)} variation wavs, figure "
        f"{want_size[0]} x {want_size[1]} px ({len(png)} B); the card's "
        f"wavs vs the CPU's float32 model, max|err|/peak {worst:.3e}; wall "
        f"per sample {' '.join(f'{w * 1e3:.1f}' for w in walls)} ms (the "
        f"second is the reading) on {card_line()}")
    check(worst < PATH_REL,
          f"the validator's wavs card vs CPU within {PATH_REL} of the peak")
    return launched


def _nppc_cli(dev, counts):
    """cli.train's nppc_denoising line on a corpus in a temporary directory:
    2 epochs of NPPC_CLI_STEPS steps, then -R for one more."""
    from generative_audio_torch.cli import train as train_cli
    from generative_audio_torch.data import write_synthetic_corpus
    from generative_audio_torch.train import nppc as N
    steps, restores = [], []
    train_step, restore = (N.NPPCDenoisingTrainer.train_step,
                           N.NPPCDenoisingTrainer.restore_latest)

    def counted_step(self, noisy, clean):
        before = dict(counts)
        t0 = time.perf_counter()
        out = train_step(self, noisy, clean)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, _launched(counts, before)))
        return out

    def recorded_restore(self):
        out = restore(self)
        restores.append((out, self.state.step))
        return out

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(N.NPPCDenoisingTrainer, "train_step",
                              counted_step), \
            mock.patch.object(N.NPPCDenoisingTrainer, "restore_latest",
                              recorded_restore):
        root = Path(tmp)
        clean_dir, noise_dir = write_synthetic_corpus(
            root, n_clean=NPPC_CLI_CLEAN, n_noise=NPPC_CLI_NOISE,
            seconds=NPPC_CLI_SECONDS, seed=SEED)
        cfg = {"line": "nppc_denoising", "checkpoint_dir": str(root / "ckpt"),
               "train": NPPC_CLI_TRAIN,
               "data": {"clean_path": str(clean_dir),
                        "noisy_path": str(noise_dir),
                        "sub_sample_length_seconds": 3.0},
               "dataloader": {"num_workers": NPPC_CLI_WORKERS, "seed": SEED}}
        path = root / "nppc.json"
        path.write_text(json.dumps(cfg, indent=1))
        argv = ["-C", str(path), "--steps", str(NPPC_CLI_STEPS)]
        before = dict(counts)
        first = train_cli.main(argv + ["--epochs", "2"])
        second = train_cli.main(argv + ["--epochs", "1", "-R"])
        launched = _launched(counts, before)
        metrics = sorted((root / "ckpt").glob("metrics_final_*.json"))
        final = json.loads(metrics[-1].read_text()) if metrics else {}
    n = 3 * NPPC_CLI_STEPS
    # the float32 enhancer's forward (float32 h) over a batch of 8 clips
    per_step = routed_counts(("lstm_scan_fwd", 8 * ROWS // 8, 2, True),
                             ("lstm_scan_fwd_train", 8 * ROWS // 8, 2),
                             ("lstm_scan_bwd", 8 * ROWS // 8, 2))
    n_dirs = [t.state.model.config.pc_wrapper.n_directions
              for t in (first, second)]
    log(f"nppc CLI: {NPPC_CLI_CLEAN} clean + {NPPC_CLI_NOISE} noise clips of "
        f"{NPPC_CLI_SECONDS} s, batch 8 x 3.0 s, {NPPC_CLI_WORKERS} workers, "
        f"the line's float32 (mixed route): "
        f"{n_dirs} directions, objectives {first.loss_history} then "
        f"{second.loss_history}, restores {restores}, steps "
        f"{' '.join(f'{s * 1e3:.1f}' for s, _ in steps)} ms, final metrics "
        f"{final}")
    check(n_dirs == [5, 5], "the yaml's n_dirs built 5 directions")
    check(all(t.state.model.pretrained_restoration_model.compute_dtype
              == torch.float32 for t in (first, second)),
          "the nppc_denoising line trains in float32, the JAX line's dtype")
    check(len(steps) == n and all(got == per_step for _, got in steps),
          f"each CLI step launched {per_step} and nothing else")
    check(restores == [(True, 2 * NPPC_CLI_STEPS)]
          and second.state.step == n,
          f"-R resumed at step {2 * NPPC_CLI_STEPS} and ran to {n}")
    check(final.get("total_steps") == n
          and np.isfinite(first.loss_history + second.loss_history).all(),
          "metrics_final_*.json written, finite objectives")
    return launched


def phase_nppc_denoising(dev):
    """Phase 16: the denoising-NPPC line at full width, bf16. Returns the
    launches of its paths by kernel (the model's forward, the training
    steps, the validator and the CLI; not the comparisons)."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.utils import convert
    t_phase = time.perf_counter()
    cfg = nppc_config()
    params = convert.random_denoising_nppc_params(cfg, seed=SEED + 20)
    sd = convert.convert_denoising_nppc(params)
    counts = L.launch_counts
    L.reset_launch_counts()
    card_model, cpu_model, launched = _nppc_model_check(dev, cfg, sd, counts)
    total = dict(launched)
    L.reset_launch_counts()
    for k, v in _nppc_head_seeds(dev, cfg, counts).items():
        total[k] = total.get(k, 0) + v
    L.reset_launch_counts()
    trainer, (noisy, clean), launched = _nppc_training(dev, cfg, params,
                                                       counts)
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    _profile(lambda: trainer.train_step(noisy, clean),
             f"nppc training step, batch {NPPC_BATCH} x "
             f"{NPPC_SAMPLES / 16000:.3f} s, {cfg.pc_wrapper.n_directions} "
             f"directions")
    del trainer, noisy, clean
    _nppc_reference(dev, cfg, params)
    L.reset_launch_counts()
    for k, v in _nppc_validation(dev, card_model, cpu_model, counts).items():
        total[k] = total.get(k, 0) + v
    del card_model, cpu_model
    L.reset_launch_counts()
    for k, v in _nppc_cli(dev, counts).items():
        total[k] = total.get(k, 0) + v
    log(f"launches on the denoising-NPPC paths of phase 16: {total}")
    log(f"phase 16: {time.perf_counter() - t_phase:.2f} s")
    return total


# Phase 17: the inpainting-NPPC line at the full width of
# configs/inpainting_restoration.yaml and configs/inpainting_nppc.yaml: the
# UNets 64 -> 512, a 128 x 256 log-magnitude spectrogram (nfft 255, hop 128,
# 2.044 s at 16 kHz), batch 128, 5 directions; random weights from a numpy
# seed in the JAX layout (convert.random_inpainting_nppc_params).
INPAINT_F, INPAINT_T, INPAINT_BATCH, INPAINT_STEPS = 128, 256, 128, 5
INPAINT_GAP_FRAMES = 18          # 0.128 s of 16 kHz under 255-point windows
INPAINT_MC_BATCH, INPAINT_MC_STEPS = 16, 3
INPAINT_TF32_BATCH = 4
# the shipped configs' train: blocks, as JSON (no PyYAML on the card's
# machine)
INPAINT_REST_TRAIN = {"model": {"in_channels": 1, "out_channels": 1,
                                "dropout": 0.2},
                      "learning_rate": 0.0001, "betas": [0.5, 0.999],
                      "clip_grad_norm": 5.0, "num_freqs": 128,
                      "num_frames": 256}
INPAINT_NPPC_TRAIN = {"model": {"restoration": INPAINT_REST_TRAIN["model"],
                                "pc_wrapper": {"in_channels": 2,
                                               "out_channels": 5, "n_dirs": 5,
                                               "dropout": 0.0}},
                      "learning_rate": 0.0001, "betas": [0.5, 0.999],
                      "max_grad_norm": 1.0, "second_moment_loss_lambda": 1.0,
                      "second_moment_loss_grace": 500, "num_freqs": 128,
                      "num_frames": 256}
INPAINT_DATA = {"sample_rate": 16000, "missing_length_seconds": 0.128,
                "missing_start_seconds": 0.4,
                "sub_sample_length_seconds": 2.044, "target_dB_FS": -25.0,
                "stft_configuration": {"nfft": 255, "hop_length": 128,
                                       "win_length": 255}}
INPAINT_CLI_FILES, INPAINT_CLI_SECONDS = (2, 2, 6), (2.5, 4.0)
INPAINT_CLI_BATCH, INPAINT_CLI_STEPS, INPAINT_CLI_WORKERS = 16, 2, 8
# The UNet on the card with TF32 convolutions (cuDNN's default) against
# strict float32 on the card, batch 4 in training: the loss (relative;
# measured 1.5e-4 and 2.1e-4 on an H100) and, per parameter tensor whose
# gradient norm is above 1e-3 of the largest, the cosine (lowest measured
# 0.99918) and the ratio of the gradient norms (0.9981-1.0035). Margins of
# about 5x (on 1 - cosine, and on the ratio's distance from 1).
INPAINT_TF32_LOSS_REL, INPAINT_TF32_COS, INPAINT_TF32_RATIO = 1e-3, 0.995, 0.02
# Gram-Schmidt in float32 over D = 128 x 256: the largest |<w_i, w_j>| of
# two unit directions of one item
INPAINT_ORTHO_ABS = 1e-4


def _inpaint_batch(seed, batch):
    """(stft_masked, mask_frames, stft_clean) numpy: seeded normal spectra
    [batch, 2, 128, 256] and an 18-frame gap at a seeded place per item."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((batch, 2, INPAINT_F, INPAINT_T),
                                np.float32)
    mask = np.ones((batch, INPAINT_T), np.float32)
    for b, start in enumerate(rng.integers(8, INPAINT_T - 8
                                           - INPAINT_GAP_FRAMES, batch)):
        mask[b, start:start + INPAINT_GAP_FRAMES] = 0
    return clean * mask[:, None, None, :], mask, clean


def _inpaint_config():
    from generative_audio_torch.train import NPPCInpaintingTrainConfig
    from generative_audio_torch.utils.config import build_dataclass
    return build_dataclass(NPPCInpaintingTrainConfig, INPAINT_NPPC_TRAIN)


def _unit_gram_off(w):
    """The largest |<w_i, w_j>|, i != j, of the unit directions of each
    item of w [B, K, F, T] (float64)."""
    flat = w.double().flatten(2)
    unit = flat / torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
    gram = (unit @ unit.transpose(1, 2)).abs()
    return (gram - torch.diag_embed(torch.diagonal(gram, dim1=1, dim2=2))
            ).max().item()


def _inpaint_card_vs_cpu(dev, sd):
    """Restoration output and NPPC w_mat on 2 items: the card with TF32 and
    in strict float32 against the float32 CPU model; the card's directions
    orthogonal."""
    from generative_audio_torch.models import InpaintingNPPCModel
    from generative_audio_torch.ops.preprocess import preprocess_data
    from generative_audio_torch.utils.device import conv_tf32
    cfg = _inpaint_config().model
    cpu = InpaintingNPPCModel(cfg)
    cpu.load_state_dict(sd)
    card = InpaintingNPPCModel(cfg).to(dev)
    card.load_state_dict(sd)
    batch = [torch.from_numpy(x) for x in _inpaint_batch(SEED + 31, 2)]
    _, mask, masked = preprocess_data(batch[2], batch[0], batch[1])
    with torch.no_grad():
        want_r = cpu.pretrained_restoration_model(masked, mask)
        want_w = cpu(masked, mask)
        got = {}
        for tf32 in (True, False):
            with conv_tf32(tf32):
                x, m = masked.to(dev), mask.to(dev)
                got[tf32] = (card.pretrained_restoration_model(x, m).cpu(),
                             card(x, m).cpu())
    rel = {tf32: (_rel(r.numpy(), want_r.numpy()), _rel(w.numpy(),
                                                         want_w.numpy()))
           for tf32, (r, w) in got.items()}
    off = _unit_gram_off(got[True][1])
    log(f"inpainting model, 2 x 1 x {INPAINT_F} x {INPAINT_T}: card vs CPU "
        f"(float32) max|err|/peak, TF32: restoration {rel[True][0]:.3e}, "
        f"w_mat {rel[True][1]:.3e}; strict float32: restoration "
        f"{rel[False][0]:.3e}, w_mat {rel[False][1]:.3e}; largest "
        f"|<w_i, w_j>| of the card's unit directions {off:.3e}")
    check(max(rel[True] + rel[False]) < PATH_REL,
          f"inpainting forward card vs CPU within {PATH_REL} of the peak")
    check(off < INPAINT_ORTHO_ABS,
          f"the card's directions orthogonal within {INPAINT_ORTHO_ABS}")
    check(got[True][1].shape == (2, 5, INPAINT_F, INPAINT_T),
          "w_mat [2, 5, 128, 256]")


def _timed_steps(step, n):
    """n calls of step(), each synchronised; (ms of each, median of steps
    2..n, peak memory in GiB)."""
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, statistics.median(ms[1:]), \
        torch.cuda.max_memory_allocated() / 2 ** 30, out


def _grads(model):
    return {k: p.grad.detach().float().clone() for k, p in
            model.named_parameters() if p.grad is not None}


def _inpaint_tf32_gap(dev, sd):
    """One restoration loss and gradient at batch 4 with TF32 and in strict
    float32 (the same weights, batch and dropout masks): every gradient
    finite and non-zero, and the gap."""
    from generative_audio_torch.train import (
        RestorationTrainConfig, RestorationTrainer)
    from generative_audio_torch.train.restoration import device_batch
    from generative_audio_torch.utils.config import build_dataclass
    from generative_audio_torch.utils.device import conv_tf32
    cfg = build_dataclass(RestorationTrainConfig, INPAINT_REST_TRAIN)
    batch = device_batch(_inpaint_batch(SEED + 32, INPAINT_TF32_BATCH), dev)
    out = {}
    for tf32 in (True, False):
        trainer = RestorationTrainer(cfg, seed=SEED, device=dev)
        trainer.state.model.load_state_dict(sd)
        with conv_tf32(tf32):
            loss = trainer.loss(batch, train=True)
            loss.backward()
        out[tf32] = (loss.item(), _grads(trainer.state.model))
    (l_tf, g_tf), (l_32, g_32) = out[True], out[False]
    check(all(torch.isfinite(g).all() and g.abs().max() > 0
              for g in g_tf.values()) and len(g_tf) == len(
                  list(trainer.state.model.parameters())),
          "every restoration gradient finite and non-zero")
    top = max(g.norm().item() for g in g_32.values())
    cos, ratio = [], []
    for k, g in g_32.items():
        if g.norm().item() > 1e-3 * top:
            cos.append(torch.nn.functional.cosine_similarity(
                g_tf[k].flatten(), g.flatten(), dim=0).item())
            ratio.append(g_tf[k].norm().item() / g.norm().item())
    loss_rel = abs(l_tf - l_32) / abs(l_32)
    log(f"restoration TF32 vs float32 on the card, batch "
        f"{INPAINT_TF32_BATCH}: loss {l_tf:.6f} vs {l_32:.6f} (rel "
        f"{loss_rel:.3e}); over {len(cos)} gradient tensors cosine >= "
        f"{min(cos):.6f}, norm ratio {min(ratio):.5f}-{max(ratio):.5f}")
    check(loss_rel < INPAINT_TF32_LOSS_REL and min(cos) > INPAINT_TF32_COS
          and max(abs(r - 1) for r in ratio) < INPAINT_TF32_RATIO,
          f"TF32 within {INPAINT_TF32_LOSS_REL} (loss), {INPAINT_TF32_COS} "
          f"(cosine) and {INPAINT_TF32_RATIO} (norms) of float32")


def _inpaint_restoration_training(dev, sd, card):
    """RestorationTrainer at batch 128 for 5 steps on one batch: ms per
    step, samples/s, peak memory, the running statistics moved."""
    from generative_audio_torch.train import (
        RestorationTrainConfig, RestorationTrainer)
    from generative_audio_torch.utils.config import build_dataclass
    trainer = RestorationTrainer(
        build_dataclass(RestorationTrainConfig, INPAINT_REST_TRAIN),
        seed=SEED, device=dev)
    trainer.state.model.load_state_dict(sd)
    stats0 = {k: v.clone() for k, v in trainer.state.model.state_dict().items()
              if "running" in k}
    batch = _inpaint_batch(SEED + 33, INPAINT_BATCH)
    ms, median, peak, loss = _timed_steps(lambda: trainer.train_step(batch),
                                          INPAINT_STEPS)
    moved = sum(not torch.equal(v, trainer.state.model.state_dict()[k])
                for k, v in stats0.items())
    log(f"restoration training, batch {INPAINT_BATCH} x 1 x {INPAINT_F} x "
        f"{INPAINT_T}: steps {' '.join(f'{x:.1f}' for x in ms)} ms, median "
        f"of 2-{INPAINT_STEPS} {median:.2f} ms, "
        f"{INPAINT_BATCH * 1e3 / median:.1f} samples/s, peak memory "
        f"{peak:.2f} GiB; last loss {loss.item():.5f}; {moved} of "
        f"{len(stats0)} running statistics moved; on {card}")
    check(moved == len(stats0), "every BatchNorm running statistic moved")
    check(trainer.state.step == INPAINT_STEPS and np.isfinite(loss.item()),
          f"{INPAINT_STEPS} steps taken, finite loss")
    return trainer, batch, median


def _inpaint_nppc_training(dev, rest_sd, head_sd, batch, card):
    """NPPCInpaintingTrainer (base step) at batch 128 over the trained
    restoration model, 5 steps: the frozen model's parameters and buffers
    bit for bit unchanged, ms per step, samples/s, peak memory."""
    from generative_audio_torch.train import NPPCInpaintingTrainer
    trainer = NPPCInpaintingTrainer(_inpaint_config(),
                                    restoration_variables=rest_sd, seed=SEED,
                                    device=dev)
    trainer.state.model.pc_wrapper.net.load_state_dict(head_sd)
    frozen = trainer.state.model.pretrained_restoration_model
    before = {k: v.clone() for k, v in frozen.state_dict().items()}
    ms, median, peak, (obj, rec) = _timed_steps(
        lambda: trainer.train_step(batch), INPAINT_STEPS)
    same = all(torch.equal(v, before[k]) for k, v in
               frozen.state_dict().items())
    log(f"nppc base step, batch {INPAINT_BATCH}, 5 directions: steps "
        f"{' '.join(f'{x:.1f}' for x in ms)} ms, median {median:.2f} ms, "
        f"{INPAINT_BATCH * 1e3 / median:.1f} samples/s, peak memory "
        f"{peak:.2f} GiB; objective {obj.item():.5f}, reconst_err "
        f"{rec.item():.5f}; frozen restoration model unchanged: {same}; "
        f"on {card}")
    check(same and all(p.grad is None for p in frozen.parameters()),
          "the frozen restoration model's parameters and buffers bit for "
          "bit unchanged, without gradient")
    check(np.isfinite(obj.item()) and 0 <= rec.item() <= 1,
          "finite objective, reconst_err in [0, 1]")
    return trainer, median


def _inpaint_mc(dev, rest_sd, head_sd, card):
    """mc_pca_aligned at batch 16 (50 passes, 5 a forward), 3 steps; the
    passes chunked (5) == unchunked (50 in one forward) bit for bit."""
    from generative_audio_torch.eval import mc_dropout
    from generative_audio_torch.ops.preprocess import preprocess_data
    from generative_audio_torch.train import NPPCInpaintingTrainer
    from generative_audio_torch.utils.device import conv_tf32
    cfg = _inpaint_config()
    cfg = dataclasses.replace(cfg, objective_variant="mc_pca_aligned")
    trainer = NPPCInpaintingTrainer(cfg, restoration_variables=rest_sd,
                                    seed=SEED, device=dev)
    trainer.state.model.pc_wrapper.net.load_state_dict(head_sd)
    batch = _inpaint_batch(SEED + 34, INPAINT_MC_BATCH)
    ms, median, peak, (obj, rec) = _timed_steps(
        lambda: trainer.train_step(batch), INPAINT_MC_STEPS)
    log(f"nppc mc_pca_aligned step, batch {INPAINT_MC_BATCH}, "
        f"{cfg.n_mc_samples} passes {cfg.mc_chunk_size} a forward: steps "
        f"{' '.join(f'{x:.1f}' for x in ms)} ms, median {median:.2f} ms, "
        f"peak memory {peak:.2f} GiB; objective {obj.item():.5f}, "
        f"reconst_err {rec.item():.5f}; on {card}")
    check(np.isfinite(obj.item()), "finite mc_pca_aligned objective")
    model = trainer.state.model
    clean, mask, masked = preprocess_data(*(torch.from_numpy(x).to(dev) for x
                                            in (batch[2], batch[0], batch[1])))
    with torch.no_grad(), conv_tf32(True):
        runs = {}
        for chunk in (cfg.mc_chunk_size, 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[chunk] = mc_dropout.mc_dropout_inference(
                model.mc_restoration, masked, mask,
                mc_dropout.mc_generators(SEED + 35, cfg.n_mc_samples, dev),
                chunk_size=chunk)
            torch.cuda.synchronize()
            runs[chunk, "ms"] = (time.perf_counter() - t0) * 1e3
    a, b = runs[cfg.mc_chunk_size], runs[0]
    distinct = (a[0] - a[1]).abs().max().item()
    log(f"MC passes {cfg.n_mc_samples} x batch {INPAINT_MC_BATCH}: chunked "
        f"({cfg.mc_chunk_size}) {runs[cfg.mc_chunk_size, 'ms']:.1f} ms, "
        f"unchunked {runs[0, 'ms']:.1f} ms, equal bit for bit: "
        f"{torch.equal(a, b)}; passes 0 and 1 differ by {distinct:.3e}")
    check(torch.equal(a, b), "chunked MC passes == unchunked bit for bit")
    check(distinct > 0, "the MC passes differ")
    return median, peak


def _inpaint_validators(dev, trainer, card):
    """RestorationValidator on 4 items and NPPCValidator on one (50 MC
    passes, the 13-alpha grid, 25 wavs with the clean phase, pitch, the
    JSON and the PNGs): wall per sample, its time on the card (CUDA events
    around the models) and on the host."""
    from generative_audio_torch.eval import (
        NPPCValidator, NPPCValidatorConfig, RestorationValidator,
        RestorationValidatorConfig)
    from generative_audio_torch.eval import nppc_validator as NV
    from generative_audio_torch.ops.preprocess import preprocess_data
    from generative_audio_torch.ops.stft import stft_ri
    model = trainer.state.model
    stft = INPAINT_DATA["stft_configuration"]
    seconds = INPAINT_DATA["sub_sample_length_seconds"]
    wav = (_speech_like(SEED + 36, seconds)[:int(seconds * 16000)]
           .astype(np.float32) * 0.3)
    re, im = stft_ri(torch.from_numpy(wav)[None], stft["nfft"],
                     stft["hop_length"], stft["win_length"])
    clean = torch.stack([re, im], dim=1).numpy()           # [1, 2, F, T]
    g0 = clean.shape[-1] // 5
    frames = np.ones((1, clean.shape[-1]), np.float32)
    frames[:, g0:g0 + INPAINT_GAP_FRAMES] = 0
    masked = clean * frames[:, None, None, :]
    with tempfile.TemporaryDirectory() as tmp:
        rv = RestorationValidator(
            lambda x, m: model.pretrained_restoration_model(x, m),
            RestorationValidatorConfig(save_dir=f"{tmp}/rest"), device=dev)
        t0 = time.perf_counter()
        summary = rv.validate_dataloader(
            [_inpaint_batch(SEED + 37, 4)], max_samples=4)
        rest_ms = (time.perf_counter() - t0) * 1e3 / 4

        def restoration(x, m, generator=None):
            return (model.get_pred_spec_mag_norm(x, m) if generator is None
                    else model.mc_restoration(x, m, generator))

        val = NPPCValidator(model, restoration, NPPCValidatorConfig(
            save_dir=f"{tmp}/nppc", nfft=stft["nfft"],
            hop_length=stft["hop_length"], win_length=stft["win_length"]),
            device=dev)
        events = []
        device_outputs = val.device_outputs

        def timed(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = device_outputs(*a, **k)
            end.record()
            events.append((start, end))
            return out

        val.device_outputs = timed
        c, m, x, mean, std = preprocess_data(
            *(torch.from_numpy(a) for a in (clean, masked, frames)),
            return_stats=True)
        t0 = time.perf_counter()
        metrics = val.validate_sample(
            x, m, c, sample_idx=0, stats=(mean, std),
            clean_phase=np.arctan2(clean[0, 1], clean[0, 0]),
            full_audio=wav, gap_bounds=(
                g0 * stft["hop_length"],
                (g0 + INPAINT_GAP_FRAMES) * stft["hop_length"]))
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        card_ms = sum(s.elapsed_time(e) for s, e in events)
        out = Path(tmp) / "nppc" / "sample_0"
        wavs = sorted(out.glob("pc*_alpha*.wav"))
        pngs = list(out.rglob("*.png"))
        rows = NV.organize_jsons(Path(tmp) / "nppc")
        val.plot_pitch_comparison(
            {p.stem: _read_wav(p) for p in wavs[:5]}, out)
        pitch = (out / "pitch_comparison.png").exists()
    f0 = [v["mean_f0"] for v in metrics["audio_variations"]
          if v["mean_f0"] is not None]
    log(f"restoration validator: 4 items, mean gap MSE "
        f"{summary['mean_gap_mse']:.5f}, {rest_ms:.1f} ms a sample")
    log(f"nppc validator: one {seconds} s sample, {len(wavs)} wavs, {len(pngs)} "
        f"PNGs, metrics nppc {metrics['nppc']}, mc_dropout "
        f"{metrics['mc_dropout']}, principal angles "
        f"{[round(a, 2) for a in metrics['principal_angles']]}, mean f0 of "
        f"{len(f0)} voiced variations "
        f"{min(f0, default=float('nan')):.1f}-"
        f"{max(f0, default=float('nan')):.1f} Hz; wall {wall:.1f} ms a "
        f"sample: "
        f"card {card_ms:.1f} ms (CUDA events around the models and the "
        f"PCA), host {wall - card_ms:.1f} ms; on {card}")
    check(summary["num_samples"] == 4
          and np.isfinite(summary["mean_gap_mse"]), "restoration validation")
    check(len(wavs) == 25 and len(pngs) == 1 + 4 + 5 * 14 and pitch
          and len(rows) == 1 and len(metrics["principal_angles"]) == 5,
          "the NPPC validator's 25 wavs, 75 PNGs, pitch figure and JSON row")
    return wall, card_ms, rest_ms


def _read_wav(path):
    from generative_audio_torch.data.audio_io import load_audio
    return load_audio(path, 16000)


def _inpaint_corpus(root):
    """A LibriSpeech layout under root: speaker/chapter/{s}-{c}-{i}.flac
    (16-bit verbatim FLAC) and {s}-{c}.trans.txt."""
    rng = np.random.default_rng(SEED + 38)
    n_spk, n_chap, n_files = INPAINT_CLI_FILES
    for s in range(n_spk):
        for c in range(n_chap):
            chapter = root / f"{100 + s}" / f"{200 + c}"
            chapter.mkdir(parents=True)
            lines = []
            for i in range(n_files):
                stem = f"{100 + s}-{200 + c}-{i:04d}"
                audio = _speech_like(int(rng.integers(1 << 30)),
                                     rng.uniform(*INPAINT_CLI_SECONDS))
                (chapter / f"{stem}.flac").write_bytes(_verbatim_flac(
                    np.round(audio * 0.5 * 32767).astype(np.int16)))
                lines.append(f"{stem} SPEAKER {s} CHAPTER {c} LINE {i}")
            (chapter / f"{100 + s}-{200 + c}.trans.txt").write_text(
                "\n".join(lines) + "\n")
    return n_spk * n_chap * n_files


def _inpaint_loader_ms(data):
    """The loader alone: host ms a batch of one pass over the corpus (FLAC
    decode, gap, STFT, collate) at the CLI's batch and workers."""
    from generative_audio_torch.data import (
        AudioInpaintingConfig, AudioInpaintingDataset, BatchLoader,
        collate_inpainting)
    from generative_audio_torch.utils.config import build_dataclass
    loader = BatchLoader(
        AudioInpaintingDataset(build_dataclass(AudioInpaintingConfig, data),
                               seed=SEED),
        global_batch_size=INPAINT_CLI_BATCH, num_workers=INPAINT_CLI_WORKERS,
        collate_fn=collate_inpainting, seed=SEED)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) * 1e3 / max(n, 1)


def _inpaint_cli(dev, card):
    """cli.train's restoration line on a FLAC corpus (2 epochs of 2 steps
    at batch 16 with a validation block, then -R for one more), then the
    nppc_inpainting line over its checkpoint directory, then -R: loader-fed
    step times."""
    from generative_audio_torch.cli import train as train_cli
    from generative_audio_torch.train import nppc as N
    from generative_audio_torch.train import restoration as R
    steps = {"restoration": [], "nppc": []}
    validations = []
    originals = (R.RestorationTrainer.train_step,
                 N.NPPCInpaintingTrainer.train_step,
                 R.RestorationTrainer.validate)

    def timed(original, key):
        def step(self, batch):
            out = original(self, batch)
            torch.cuda.synchronize()
            steps[key].append((id(self), time.perf_counter()))
            return out
        return step

    def timed_validate(self, loader):
        t0 = time.perf_counter()
        out = originals[2](self, loader)
        validations.append((t0, time.perf_counter()))
        return out

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(R.RestorationTrainer, "train_step",
                              timed(originals[0], "restoration")), \
            mock.patch.object(N.NPPCInpaintingTrainer, "train_step",
                              timed(originals[1], "nppc")), \
            mock.patch.object(R.RestorationTrainer, "validate",
                              timed_validate):
        root = Path(tmp)
        n_files = _inpaint_corpus(root / "LibriSpeech")
        data = {**INPAINT_DATA, "clean_path": str(root / "LibriSpeech")}
        loader = {"global_batch_size": INPAINT_CLI_BATCH,
                  "num_workers": INPAINT_CLI_WORKERS, "seed": SEED}
        rest_cfg = {"line": "restoration",
                    "checkpoint_dir": str(root / "rest"),
                    "train": {**INPAINT_REST_TRAIN, "log_interval": 1},
                    "data": data, "validation": {**data, "seed": SEED},
                    "dataloader": loader}
        nppc_cfg = {"line": "nppc_inpainting",
                    "checkpoint_dir": str(root / "nppc"),
                    "pretrained_restoration_checkpoint": str(root / "rest"),
                    "train": {**INPAINT_NPPC_TRAIN, "log_interval": 1},
                    "data": data, "dataloader": loader}
        for name, cfg in (("rest", rest_cfg), ("nppc", nppc_cfg)):
            (root / f"{name}.json").write_text(json.dumps(cfg, indent=1))
        argv = ["--steps", str(INPAINT_CLI_STEPS)]
        t0 = time.perf_counter()
        first = train_cli.main(["-C", str(root / "rest.json"), "--epochs",
                                "2"] + argv)
        second = train_cli.main(["-C", str(root / "rest.json"), "--epochs",
                                 "1", "-R"] + argv)
        rest_wall = time.perf_counter() - t0
        best = json.loads((root / "rest" / "best_score.json").read_text())
        nppc = train_cli.main(["-C", str(root / "nppc.json")] + argv)
        frozen = nppc.state.model.pretrained_restoration_model.state_dict()
        best_sd = torch.load(root / "rest" / "best.pt", map_location="cpu",
                             weights_only=True)["params"]
        from_best = all(torch.equal(frozen[k].cpu(), v)
                        for k, v in best_sd.items())
        resumed = train_cli.main(["-C", str(root / "nppc.json"), "-R"] + argv)
        loader_ms = _inpaint_loader_ms(data)
    # the time from one step's end to the next one's of the same run, the
    # loader's wait included and the validations in between taken out
    gaps = {k: np.array([(b - a - sum(v1 - v0 for v0, v1 in validations
                                      if a <= v0 < b)) * 1e3
                         for (ra, a), (rb, b) in zip(v, v[1:]) if ra == rb])
            for k, v in steps.items()}
    log(f"inpainting CLI: {n_files} FLAC clips of "
        f"{INPAINT_CLI_SECONDS[0]}-{INPAINT_CLI_SECONDS[1]} s, batch "
        f"{INPAINT_CLI_BATCH}, {INPAINT_CLI_WORKERS} workers: restoration "
        f"losses {first.loss_history} then {second.loss_history} (steps "
        f"{first.state.step}, {second.state.step}; val "
        f"{[round(v, 4) for _, v in first.val_loss_history]} then "
        f"{[round(v, 4) for _, v in second.val_loss_history]}; best "
        f"{best}), {rest_wall:.1f} s with validation; nppc objectives "
        f"{nppc.loss_history} then {resumed.loss_history} (steps "
        f"{nppc.state.step}, {resumed.state.step}); the frozen UNet is best/: "
        f"{from_best}; loader-fed step times (validation out) restoration "
        f"{' '.join(f'{g:.1f}' for g in gaps['restoration'])} ms, nppc "
        f"{' '.join(f'{g:.1f}' for g in gaps['nppc'])} ms; the loader alone "
        f"{loader_ms:.1f} ms a batch; on {card}")
    n = 2 * INPAINT_CLI_STEPS
    check(first.state.step == n and second.state.step == n
          + INPAINT_CLI_STEPS, "the restoration line ran and resumed")
    vals = [v for _, v in first.val_loss_history + second.val_loss_history]
    check(len(vals) == n + INPAINT_CLI_STEPS
          and abs(best["score"] - min(vals)) <= 1e-6 * abs(min(vals))
          and second.best_val == best["score"],
          "best/ holds the validation minimum across the resume")
    check(from_best, "nppc_inpainting froze the restoration line's best/")
    check(nppc.state.step == INPAINT_CLI_STEPS
          and resumed.state.step == n
          and np.isfinite(first.loss_history + second.loss_history
                          + nppc.loss_history + resumed.loss_history).all(),
          "the nppc_inpainting line ran and resumed, finite losses")
    return float(np.median(np.concatenate([gaps["restoration"],
                                           gaps["nppc"]])))


def phase_inpainting(dev):
    """Phase 17: the inpainting-NPPC line at full width. No scan kernel is
    on its path: every count of ops.lstm.launch_counts stays 0."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.utils import convert
    t_phase = time.perf_counter()
    card = card_line()
    cfg = _inpaint_config()
    L.reset_launch_counts()
    params = convert.random_inpainting_nppc_params(cfg.model, seed=SEED + 30)
    sd = convert.convert_inpainting_nppc(params)
    rest_sd = {k[len("pretrained_restoration_model."):]: v for k, v in
               sd.items() if k.startswith("pretrained_restoration_model.")}
    head_sd = {k[len("pc_wrapper.net."):]: v for k, v in sd.items()
               if k.startswith("pc_wrapper.net.")}
    _inpaint_card_vs_cpu(dev, sd)
    _inpaint_tf32_gap(dev, rest_sd)
    trainer, batch, rest_ms = _inpaint_restoration_training(dev, rest_sd,
                                                            card)
    _profile(lambda: trainer.train_step(batch),
             f"restoration training step, batch {INPAINT_BATCH}")
    trained = {k: v.detach().cpu().clone() for k, v in
               trainer.state.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    nppc, nppc_ms = _inpaint_nppc_training(dev, trained, head_sd, batch, card)
    _profile(lambda: nppc.train_step(batch),
             f"nppc base step, batch {INPAINT_BATCH}, 5 directions")
    del nppc, batch
    torch.cuda.empty_cache()
    mc_ms, mc_peak = _inpaint_mc(dev, trained, head_sd, card)
    from generative_audio_torch.train import NPPCInpaintingTrainer
    val_trainer = NPPCInpaintingTrainer(cfg, restoration_variables=trained,
                                        seed=SEED, device=dev)
    val_trainer.state.model.pc_wrapper.net.load_state_dict(head_sd)
    _inpaint_validators(dev, val_trainer, card)
    del val_trainer
    torch.cuda.empty_cache()
    _inpaint_cli(dev, card)
    launched = {k: v for k, v in L.launch_counts.items() if v}
    log(f"scan kernel launches in phase 17: {launched or 0}")
    check(not launched, "no scan kernel launched on the inpainting line")
    log(f"phase 17: {time.perf_counter() - t_phase:.2f} s")


# Phase 18: the rest of queue A item 5 at full width. FullSubNet+ (F=257,
# TCN towers 512, sub-band LSTM H=384, bf16) in seven configurations that
# between them take every norm and every channel attention, as (attention,
# subband_num, norm); the complex LSTM and GRU on the scan kernels; MOSNet at
# its published width; the small blocks. Random weights from a numpy seed in
# the JAX layout, carried across by utils/convert.py.
VARIANTS = (("TSSE", 10, "offline_laplace_norm"),
            ("SE", 2, "cumulative_laplace_norm"),
            ("CBAM", 1, "offline_gaussian_norm"),
            ("ECA", 1, "cumulative_layer_norm"),
            ("TSSE", 1, "forgetting_norm"),
            ("SE", 1, "sband_forgetting_norm"),
            ("CBAM", 1, "hybrid_norm"))
VARIANTS_TRAINED = 2          # the first two also take a training step
# norms that divide each frame by a running mean (_own_streams)
PER_FRAME_MEAN_NORMS = ("cumulative_laplace_norm", "forgetting_norm",
                        "sband_forgetting_norm", "hybrid_norm")
# Those norms in float64 on a 10 s request's own streams, card against CPU,
# of the peak: on the CPU the float64 result moves by up to 1.6e-8 of its
# peak under a relative change of 2e-16 of every entry (forgetting_norm's
# imaginary stream; 1e-11 at most on the magnitude and the real stream); a
# wrong coefficient or bin moves it by O(1).
NORM64_REL = 1e-6
VARIANT_REQUESTS = 3          # timed 10 s requests a configuration
# ComplexSequenceModel: 2 x 257 features in, H=384, 2 layers; (batch,
# frames) of the served request (also held against the CPU) and of the
# training step
COMPLEX_FREQS, COMPLEX_HIDDEN = 257, 384
COMPLEX_SERVE, COMPLEX_TRAIN = (8, 628), (18, 195)
MOSNET_SECONDS = (10.0, 25.0)
# MOSNet's score, float32 on the card (TF32 off) against the CPU, relative
MOSNET_REL = 1e-3
# The small blocks, float32 on the card against the CPU, of the peak
SMALL_BLOCK_REL = 1e-4
MICS = 4


def _variant_path(attention, subband_num, norm, seed):
    """A FullSubNet+ configuration as a ModelPath (serving like phase 4's,
    training with two drop_band groups)."""
    from generative_audio_torch import models as M
    from generative_audio_torch.train import EnhanceTrainConfig
    from generative_audio_torch.utils import convert
    cfg = M.FullSubNetPlusConfig(channel_attention_model=attention,
                                 subband_num=subband_num, norm_type=norm)
    return ModelPath(
        name=f"FullSubNet+ {attention}/s={subband_num}/{norm}",
        model_cls=M.FullSubNetPlus, config=cfg,
        sd=convert.convert_fullsubnet_plus(
            convert.random_fullsubnet_plus_params(cfg, seed=seed),
            attention=attention),
        mode="mag_complex_full_band_crm_mask", n_inputs=3,
        fwd="lstm_scan_fwd", carry="lstm_scan_fwd_carry", per_forward=2,
        per_long_forward=0,
        train_config=lambda dtype: EnhanceTrainConfig(
            model=dataclasses.replace(cfg, num_groups_in_drop_band=2),
            compute_dtype=dtype),
        per_step={"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2})


def magnitude(mag, real, imag):
    """The magnitude on all three streams."""
    return mag, mag, mag


def _own_streams(dev, path, model):
    """For a configuration whose norm divides each frame by a running mean
    (PER_FRAME_MEAN_NORMS), the parts that are well-conditioned on the real
    and imaginary streams themselves. End to end such a configuration is
    not: the sum of a frame's real parts is about N/2 times its windowed
    first sample, which the Hann window zeroes, and the first frame of a
    centred, reflect-padded STFT is even, so its imaginary parts are
    rounding noise; dividing by such means makes a few frames huge, and the
    bf16 towers and sub-band LSTM round those frames' outputs far past
    PATH_REL (phase_reference therefore feeds both models the magnitude).
    Held here on the 10 s request's own three streams: each norm in float64,
    card against CPU, within NORM64_REL of its peak, and each channel
    attention over its stream normed (float32, the model's own dtype for
    it), card against CPU, within SMALL_BLOCK_REL. On the 1 s clip, the
    distance of the whole model on its own streams and how far the float32
    model moves under a 1e-6 change of the waveform are printed."""
    import torch.nn.functional as F
    from generative_audio_torch.models.fullsubnet_plus import attend
    from generative_audio_torch.ops import prepare_input_from_waveform
    ref = path.model(torch.float32, "cpu")
    s = path.config.subband_num
    streams = prepare_input_from_waveform(
        torch.from_numpy(_noise(SEED + 50, 160000))[None], 512, 256, 512)[:3]
    rel_norm, rel_attend = [], []
    with torch.inference_mode():
        for x, suffix in zip(streams, ("", "_real", "_imag")):
            x = F.pad(x, (0, path.config.look_ahead)).double()
            want = ref.norm(x)
            got = model.norm(x.to(dev)).cpu()
            check(torch.isfinite(got).all().item(), f"{path.name}: finite "
                  f"float64 norm on the 10 s stream{suffix or '_mag'}")
            rel_norm.append(_rel(got.numpy(), want.numpy()))
            normed = want.float()
            want = attend(normed, getattr(ref, f"channel_attention{suffix}"), s)
            got = attend(normed.to(dev), getattr(
                model, f"channel_attention{suffix}"), s).cpu()
            rel_attend.append(_rel(got.numpy(), want.numpy()))
        wav = np.random.default_rng(SEED + 1).standard_normal(16000).astype(
            np.float32) * 0.1
        moved = wav * (1 + 1e-6 * np.random.default_rng(SEED + 2)
                       .standard_normal(16000).astype(np.float32))
        own, own_moved = (prepare_input_from_waveform(
            torch.from_numpy(w)[None], 512, 256, 512)[:3] for w in (wav, moved))
        want = ref(*own)
        got = model(*(x.to(dev) for x in own)).float().cpu()
        rel_own = ((got - want).abs().max() / want.abs().max()).item()
        moves = ((ref(*own_moved) - want).abs().max()
                 / want.abs().max()).item()
    log(f"own streams {path.name}: 10 s request's mag, real, imag: float64 "
        f"norm card vs CPU max|err|/peak "
        f"{' '.join(f'{r:.3e}' for r in rel_norm)}; attention over them "
        f"(float32) {' '.join(f'{r:.3e}' for r in rel_attend)}; 1 s clip end "
        f"to end, bf16 card vs float32 CPU {rel_own:.3e}, where the float32 "
        f"model moves by {moves:.3e} of its peak under a 1e-6 change of the "
        f"waveform (not checked)")
    check(max(rel_norm) < NORM64_REL, f"{path.name}: float64 norm on the own "
          f"streams, card vs CPU within {NORM64_REL}")
    check(max(rel_attend) < SMALL_BLOCK_REL, f"{path.name}: attention over "
          f"the normed own streams, card vs CPU within {SMALL_BLOCK_REL}")


def _ten_second_requests(dev, path, model, counts):
    """A warm-up and VARIANT_REQUESTS timed 10 s requests, each launching
    kernel A exactly twice. Returns (median ms, its RTF)."""
    inf = path.inferencer(model, dev)
    noisy = _noise(SEED + 50, 160000)
    readings = []
    for i in range(VARIANT_REQUESTS + 1):
        t0 = time.perf_counter()
        out = _count(counts, lambda: inf.enhance(noisy),
                     {routed(path.fwd, ROWS // 8): path.per_forward},
                     f"{path.name} 10 s request")
        if i:
            readings.append(((time.perf_counter() - t0) * 1e3, inf.last_rtf))
    check(out.shape == noisy.shape and np.isfinite(out).all(),
          f"{path.name} 10 s request: shape and finite")
    return sorted(readings)[len(readings) // 2]


def _variant_training_step(dev, path, counts):
    """One EnhanceTrainer step at 18 x 3.072 s: exactly 2 C and 2 D, a
    finite loss and a finite non-zero gradient for every tensor."""
    from generative_audio_torch.train import EnhanceTrainer
    trainer = EnhanceTrainer(path.train_config("bfloat16"), seed=SEED,
                             pretrained_state_dict=path.sd, device=dev)
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    verify = _first_grads(trainer.state.model.named_parameters(),
                          f"{path.name} parameter")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = _count(counts, lambda: trainer.train_epoch([(noisy, clean)]),
                  routed_step(path.per_step), f"{path.name} training step")
    ms = (time.perf_counter() - t0) * 1e3
    verify()
    check(np.isfinite(loss), f"{path.name}: finite training loss")
    log(f"phase 18 train {path.name}: batch {TRAIN_BATCH} x "
        f"{TRAIN_SAMPLES / 16000:.3f} s, loss {loss:.5f}, first step "
        f"{ms:.1f} ms (with the warm-up of its shapes)")


def _variants(dev, counts):
    """(a): each configuration's 1 s clip against the float32 model on the
    CPU, its 10 s request beside the default configuration's, and for the
    first two one training step."""
    plus = model_paths()[0]
    card = card_line()
    default_ms, default_rtf = _ten_second_requests(
        dev, plus, plus.model(torch.bfloat16, dev), counts)
    log(f"phase 18 serve {plus.name} (default: TSSE, s=1, "
        f"offline_laplace_norm) 10 s: {default_ms:.2f} ms, rtf "
        f"{default_rtf:.5f}, median of {VARIANT_REQUESTS} on {card}")
    for i, (attention, s, norm) in enumerate(VARIANTS):
        path = _variant_path(attention, s, norm, seed=SEED + 51 + i)
        model = path.model(torch.bfloat16, dev)
        if norm in PER_FRAME_MEAN_NORMS:
            phase_reference(dev, path, model, magnitude)
            _own_streams(dev, path, model)
        else:
            phase_reference(dev, path, model)
        ms, rtf = _ten_second_requests(dev, path, model, counts)
        log(f"phase 18 serve {path.name} 10 s: {ms:.2f} ms, rtf {rtf:.5f} "
            f"({ms / default_ms:.3f} x the default's {default_ms:.2f} ms) "
            f"on {card}")
        del model
        if i < VARIANTS_TRAINED:
            _variant_training_step(dev, path, counts)
        torch.cuda.empty_cache()


def _forgetting_forms(dev):
    """The forgetting family as block products (the model's form) against
    its step-by-step loop (the plain version) on the card, at a batch-8 x
    10 s request's stream (8 x 257 bins x 630 frames): agreement within
    1e-5 of the peak, and both times."""
    from generative_audio_torch.ops import norms as N
    x = torch.from_numpy(np.abs(_noise(SEED + 65, 8, 257, 630)) + 0.01).to(dev)
    card = card_line()
    for fast, slow in ((N.forgetting_norm, N.forgetting_norm_reference),
                       (N.sband_forgetting_norm,
                        N.sband_forgetting_norm_reference),
                       (N.hybrid_norm, N.hybrid_norm_reference)):
        rel = _rel(fast(x).cpu().numpy(), slow(x).cpu().numpy())
        ms, loop_ms = cuda_ms(lambda: fast(x), 20), cuda_ms(lambda: slow(x), 3)
        log(f"phase 18 {fast.__name__} [8, 257, 630]: block product "
            f"{ms:.3f} ms vs the loop over frames {loop_ms:.3f} ms "
            f"({loop_ms / ms:.1f}x), max|diff|/peak {rel:.2e} on {card}")
        check(rel < 1e-5, f"{fast.__name__}: product vs loop within 1e-5")


def _complex_models(kind, dev, seed):
    from generative_audio_torch.nn import ComplexSequenceModel
    from generative_audio_torch.utils import convert
    sd = convert.convert_complex_sequence_model(
        convert.random_complex_sequence_params(
            kind, COMPLEX_FREQS, COMPLEX_HIDDEN, COMPLEX_FREQS, seed=seed))
    models = []
    for dtype, device in ((torch.bfloat16, dev), (torch.float32, "cpu")):
        m = ComplexSequenceModel(COMPLEX_FREQS, COMPLEX_FREQS, COMPLEX_HIDDEN,
                                 sequence_model=kind, compute_dtype=dtype,
                                 device=device)
        m.load_state_dict(sd)
        models.append(m)
    return models


def _forward_scans_vs_plain(calls, what):
    """Kernel A's or the GRU forward's results on the very operands a
    forward handed lstm_scan_tm or gru_scan_tm (as _recorded_calls records
    them), against the plain versions on the card rounded to the result's
    dtype, under phase 2's and phase 9's limits. The same limits must
    reject each result with its rows rolled by one (its steps, where there
    is one row)."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    for i, (args, out) in enumerate(calls):
        gates, w_hh, *rest = args
        gates = gates.to(torch.bfloat16)
        if w_hh.shape[1] == 3 * w_hh.shape[0]:  # b_hh, reverse, out_dtype
            kernel, mean_limit = "GRU forward", GRU_FWD_MEAN_ABS
            want = G.gru_scan_reference_tm(gates, w_hh, *rest[:2])
        else:                                   # reverse, out_dtype, block_t
            kernel, mean_limit = "kernel A", KERNEL_MEAN_ABS
            want = L.lstm_scan_reference_tm(gates, w_hh, rest[0])
        want = want.to(out.dtype).float()

        def within(got):
            err = (got.float() - want).abs()
            return (err.max().item(), err.mean().item(),
                    err.max().item() < KERNEL_MAX_ABS
                    and err.mean().item() < mean_limit)
        max_e, mean_e, ok = within(out)
        axis = "rows" if out.shape[1] > 1 else "steps"
        faulty = within(out.roll(1, 1 if out.shape[1] > 1 else 0))
        log(f"{kernel} on {what}, call {i + 1} (T={out.shape[0]} "
            f"rows={out.shape[1]} H={out.shape[2]}): max|err| {max_e:.3e} "
            f"mean {mean_e:.3e}; {axis} rolled by 1: max {faulty[0]:.3e} "
            f"mean {faulty[1]:.3e}")
        check(torch.isfinite(out).all().item() and ok,
              f"{kernel} vs plain on {what}, call {i + 1} within "
              f"{KERNEL_MAX_ABS}/{mean_limit}")
        check(not faulty[2], f"the {kernel} limits reject {axis} rolled by "
              f"1 ({what}, call {i + 1})")


def _gru_bwd_vs_plain(calls, what):
    """The GRU backward (the scan and the dW_hh contraction) on the very
    operands a training step handed ops.gru's gru_scan_bwd_tm, against the
    plain versions on the card under phase 10's limits: dgx of the peak,
    dW_hh and db_hh of the plain result's norm, and the contraction alone on
    the plain streams against a float32 matmul."""
    from generative_audio_torch.ops import gru as G
    for i, ((gates, h_seq, gout, w_hh, b_hh, reverse), (dgx, dw, db)) in (
            enumerate(calls)):
        p_dgx, p_dhn, p_db = G.gru_scan_bwd_streams_reference_tm(
            gates, h_seq, gout, w_hh, b_hh, reverse)
        shifted = G.shifted_rows(h_seq, p_dgx, p_dhn, reverse)
        p_dw = G.gru_dwhh_reference(*shifted)
        alone = G.gru_dwhh(*shifted)
        err = (dgx.float() - p_dgx.float()).abs()
        peak = p_dgx.float().abs().max().item()
        rel_w, rel_b = _rel_norm(dw, p_dw), _rel_norm(db, p_db)
        rel_alone = _rel_norm(alone, p_dw)
        log(f"GRU backward on {what}, call {i + 1} (T={h_seq.shape[0]} "
            f"rows={h_seq.shape[1]} H={h_seq.shape[2]}, reverse={reverse}): "
            f"dgx max|err| {err.max().item():.3e} mean {err.mean().item():.3e} "
            f"(peak {peak:.3e}); dW_hh |err|/|dW_hh| {rel_w:.3e}, db_hh "
            f"{rel_b:.3e}; the contraction alone vs a float32 matmul "
            f"{rel_alone:.3e}")
        check(all(torch.isfinite(x.float()).all().item()
                  for x in (dgx, dw, db)) and peak > 0
              and err.max().item() < BWD_MAX_REL * peak
              and err.mean().item() < BWD_MEAN_REL * peak,
              f"GRU backward dgx vs plain on {what}, call {i + 1} within "
              f"{BWD_MAX_REL}/{BWD_MEAN_REL} of the peak")
        check(rel_w < BWD_DW_REL and rel_b < BWD_DW_REL,
              f"GRU backward dW_hh, db_hh vs plain on {what}, call {i + 1} "
              f"within {BWD_DW_REL}")
        check(rel_alone < DWHH_ALONE_REL,
              f"dW_hh contraction vs float32 matmul on {what}, call {i + 1} "
              f"within {DWHH_ALONE_REL}")


def _complex(dev, counts):
    """(b): ComplexSequenceModel with LSTM and GRU towers. A served batch
    runs each layer of each tower as ONE scan launch over the 2B rows of
    the real and the imag stream, and its output is held against the
    float32 model on the CPU; a training step launches the training scans
    of every layer once. Every scan launch of both is held on its operands
    against its plain version (those launches left out of the count)."""
    from generative_audio_torch.nn import recurrent as R
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    card = card_line()
    for kind, fwd, per_step in (
            ("LSTM", "lstm_scan_fwd",
             routed_counts(("lstm_scan_fwd_train", 2 * COMPLEX_TRAIN[0], 4),
                           ("lstm_scan_bwd", 2 * COMPLEX_TRAIN[0], 4))),
            ("GRU", "gru_scan_fwd",
             routed_counts(("gru_scan_fwd", 2 * COMPLEX_TRAIN[0], 4, False,
                            COMPLEX_HIDDEN),
                           ("gru_scan_bwd", 2 * COMPLEX_TRAIN[0], 4, False,
                            COMPLEX_HIDDEN),
                           ("gru_scan_bwd_dwhh", 0, 4)))):
        model, ref = _complex_models(kind, dev, SEED + 60)
        b, t = COMPLEX_SERVE
        x = torch.from_numpy(_noise(SEED + 62, b, 2 * COMPLEX_FREQS, t) * 10)
        with torch.inference_mode(), _recorded_calls(
                R, scan=f"{kind.lower()}_scan_tm") as recorded:
            got = _count(counts, lambda: model(x.to(dev)),
                         {routed(fwd, 2 * b, hsz=COMPLEX_HIDDEN): 4},
                         f"complex {kind} forward").float().cpu()
        rows = [out.shape[1] for _, out in recorded["scan"]]
        check(rows == [2 * b] * 4,
              f"complex {kind}: each of the 4 scans over {2 * b} rows "
              f"(got {rows})")
        _forward_scans_vs_plain(recorded["scan"], f"complex {kind} serve")
        del recorded
        with torch.inference_mode():
            want = ref(x)
            ms = cuda_ms(lambda: model(x.to(dev)), 5)
        rel = _rel(got.numpy(), want.numpy())
        log(f"phase 18 complex {kind} serve [{b}, {2 * COMPLEX_FREQS}, {t}]: "
            f"4 {fwd} launches over {2 * b} rows each, {ms:.3f} ms a forward "
            f"on {card}; bf16 on the card vs float32 on the CPU: "
            f"max|err|/peak {rel:.3e}")
        check(torch.isfinite(got).all().item() and rel < PATH_REL,
              f"complex {kind} vs float32 within {PATH_REL}")

        b, t = COMPLEX_TRAIN
        x = torch.from_numpy(_noise(SEED + 63, b, 2 * COMPLEX_FREQS, t)).to(dev)
        target = torch.from_numpy(_noise(SEED + 64, b, 2 * COMPLEX_FREQS,
                                         t)).to(dev)
        verify = _first_grads(model.named_parameters(),
                              f"complex {kind} parameter")

        def step():
            loss = ((model(x) - target) ** 2).mean()
            loss.backward()
            return loss

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (_recorded_scans(L) if kind == "LSTM" else _recorded_calls(
                G, fwd="gru_scan_tm", bwd="gru_scan_bwd_tm")) as recorded:
            loss = _count(counts, step, per_step,
                          f"complex {kind} training step")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        verify()
        check(torch.isfinite(loss).item(), f"complex {kind}: finite loss")
        log(f"phase 18 complex {kind} train [{b}, {2 * COMPLEX_FREQS}, {t}]: "
            f"launched {per_step}, loss {loss.item():.5f}, {ms:.1f} ms (first "
            f"step, with the records' copies) on {card}")
        saved = dict(counts)
        what = f"complex {kind} train"
        if kind == "LSTM":
            _scans_vs_plain(L, dev, recorded, what, 4)
        else:
            check(len(recorded["fwd"]) == 4 and len(recorded["bwd"]) == 4,
                  f"{what}: 4 forward and 4 backward calls")
            _forward_scans_vs_plain(recorded["fwd"], what)
            _gru_bwd_vs_plain(recorded["bwd"], what)
        counts.update(saved)
        del model, ref, recorded


def _mosnet(dev):
    """(c): MOSNet at its published width on a 10 s and a 25 s clip (one
    and three windows), the card against the CPU, and the card's wall per
    window."""
    from generative_audio_torch.eval.mosnet import MOSNetConfig, mosnet_score
    from generative_audio_torch.utils import convert
    cfg = MOSNetConfig()
    sd = convert.convert_mosnet(convert.random_mosnet_params(cfg, SEED + 70))
    mosnet_score(_speech_like(SEED + 71, 1.0), sd, device=dev)     # warm-up
    for i, seconds in enumerate(MOSNET_SECONDS):
        wav = _speech_like(SEED + 72 + i, seconds) * 0.3
        windows = -(-int(seconds * 16000) // 160000)
        t0 = time.perf_counter()
        got = mosnet_score(wav, sd, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        want = mosnet_score(wav, sd, device="cpu")
        rel = abs(got - want) / abs(want)
        log(f"phase 18 MOSNet {seconds:g} s ({windows} windows): card "
            f"{got:.6f} vs CPU {want:.6f} (rel {rel:.3e}); {ms / windows:.2f} "
            f"ms a window on the card (features on the host included) on "
            f"{card_line()}")
        check(np.isfinite(got) and rel < MOSNET_REL,
              f"MOSNet {seconds:g} s card vs CPU within {MOSNET_REL}")


def _card_vs_cpu(what, fn, card_args, cpu_args):
    """fn on the card and on the CPU; every output within SMALL_BLOCK_REL of
    its peak."""
    got, want = fn(*card_args), fn(*cpu_args)
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().cpu(), w.detach()
        if g.is_complex():
            g, w = torch.view_as_real(g), torch.view_as_real(w)
        check(g.shape == w.shape and torch.isfinite(g).all().item(),
              f"{what}: shape and finite")
        worst = max(worst, _rel(g.numpy(), w.numpy()))
    log(f"phase 18 {what}: card vs CPU max|err|/peak {worst:.3e}")
    check(worst < SMALL_BLOCK_REL, f"{what}: card vs CPU within "
          f"{SMALL_BLOCK_REL} of the peak")


def _small_blocks(dev):
    """(d): conv-STFT -> conv-iSTFT on 4 mics x 10 s, both directional
    feature computers, the three beamforming ops, a causal and a no-skip
    TCN stack, both causal conv blocks in train and eval; each float32, the
    card against the CPU."""
    from generative_audio_torch import ops
    from generative_audio_torch.models import FullSubNetPlusConfig
    from generative_audio_torch.nn import (
        CausalConvBlock, CausalTransConvBlock, TCNBlock, TCNStack)
    from generative_audio_torch.utils import convert
    cpu = torch.device("cpu")
    wav = torch.from_numpy(_noise(SEED + 80, MICS, 160000))

    def stft_istft(y):
        mag, phase, real, imag = ops.conv_stft(y, 512, 256)
        return real, imag, ops.conv_istft(mag, phase, 512, 256)

    _card_vs_cpu(f"conv-STFT -> conv-iSTFT, {MICS} mics x 10 s", stft_istft,
                 (wav.to(dev),), (wav,))
    pairs = [(0, m) for m in range(1, MICS)]
    kw = dict(n_fft=512, win_length=512, hop_length=256,
              input_features=("LPS", "IPD"), mic_pairs=pairs, lps_channel=0,
              use_sin_IPD=True)
    for cls in (ops.DirectionalFeatureComputer,
                ops.ChannelDirectionalFeatureComputer):
        mods = {d: (cls(**kw, device=d) if cls is ops.DirectionalFeatureComputer
                    else cls(**kw)) for d in (dev, cpu)}
        _card_vs_cpu(f"{cls.__name__}, {MICS} mics x 10 s",
                     lambda d, y: mods[d](y)[0], (dev, wav[None].to(dev)),
                     (cpu, wav[None]))

    spec = ops.mc_stft(wav[None], 512, 256)                  # [1, C, F, T]
    rng = np.random.default_rng(SEED + 81)

    def crand(*shape):
        return torch.complex(*(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)) for _ in range(2)))

    f, t = spec.shape[-2:]
    mix = spec.permute(0, 2, 1, 3).contiguous()              # [B, F, C, T]
    bf_args = (crand(1, f, t, MICS), mix)
    crf_args = (crand(1, f, t, 3), crand(1, MICS, f, 3, t))
    for name, fn, args in (
            ("apply_crf_filter", ops.apply_crf_filter, crf_args),
            ("get_power_spectral_density_matrix",
             ops.get_power_spectral_density_matrix, (mix,)),
            ("apply_beamforming_vector", ops.apply_beamforming_vector,
             bf_args)):
        _card_vs_cpu(f"{name} at F={f}, T={t}, {MICS} mics", fn,
                     tuple(a.to(dev) for a in args), args)

    blocks = convert.random_fullsubnet_plus_params(
        FullSubNetPlusConfig(), seed=SEED + 82)["fb_model"]["tcn"]
    sd = {k: v for i in range(8) for k, v in convert.convert_tcn_block(
        blocks[f"block_{i}"], f"{i}.").items()}
    x = torch.from_numpy(_noise(SEED + 83, 4, 628, 257))
    for causal, skip in ((True, True), (False, False)):
        stacks = {}
        for d in (dev, cpu):
            stacks[d] = torch.nn.Sequential(*(
                TCNBlock(257, 512, 257, dilation=dil, causal=causal,
                         use_skip_connection=skip, device=d)
                for dil in TCNStack.DILATIONS))
            stacks[d].load_state_dict(sd)
        with torch.no_grad():
            _card_vs_cpu(f"TCN stack 257 -> 512, [4, 628], causal={causal}, "
                         f"skip={skip}", lambda d, y: torch.relu(stacks[d](y)),
                         (dev, x.to(dev)), (cpu, x))

    def variables(kernel_shape, out, seed):
        g = np.random.default_rng(seed)
        fan_in = int(np.prod(kernel_shape[:3]))
        return {"params": {
            "conv": {"kernel": convert._uniform(g, kernel_shape, fan_in),
                     "bias": convert._uniform(g, (out,), fan_in)},
            "norm": {"scale": 1 + 0.1 * g.standard_normal(out).astype(
                np.float32), "bias": 0.1 * g.standard_normal(out).astype(
                np.float32)}},
            "batch_stats": {"norm": {
                "mean": 0.1 * g.standard_normal(out).astype(np.float32),
                "var": g.uniform(0.5, 1.5, out).astype(np.float32)}}}

    x = torch.from_numpy(_noise(SEED + 84, 4, 2, 257, 100)) * 10
    for cls, conv, (c_in, c_out), shape in (
            (CausalConvBlock, convert.convert_causal_conv_block, (2, 16),
             (3, 2, 2, 16)),
            (CausalTransConvBlock, convert.convert_causal_trans_conv_block,
             (2, 16), (3, 2, 2, 16))):
        sd = conv(variables(shape, c_out, SEED + 85))
        for train in (True, False):
            mods = {}
            for d in (dev, cpu):
                mods[d] = cls(c_in, c_out, device=d)
                mods[d].load_state_dict(sd)

            def run(d, y):
                out = mods[d](y, train=train)
                return out, mods[d].norm.running_mean, mods[d].norm.running_var

            with torch.no_grad():
                _card_vs_cpu(f"{cls.__name__} {c_in} -> {c_out} over [4, 2, "
                             f"257, 100], train={train} (output, running "
                             f"mean and variance)", run, (dev, x.to(dev)),
                             (cpu, x))


def phase_item5(dev):
    """Phase 18: the rest of queue A item 5 (FullSubNet+ variants, the
    complex sequence models, MOSNet, the small blocks). Returns the
    launches of its model paths by kernel (the served requests, the 1 s
    reference clips' card runs, the training steps), read around (a) and
    (b) with the counts set to 0 just before."""
    from generative_audio_torch.ops import lstm as L
    t_phase = time.perf_counter()
    L.reset_launch_counts()
    _variants(dev, L.launch_counts)
    _complex(dev, L.launch_counts)
    total = {k: v for k, v in L.launch_counts.items() if v}
    log(f"launches on the model paths of phase 18: {total}")
    _forgetting_forms(dev)
    _mosnet(dev)
    _small_blocks(dev)
    log(f"phase 18: {time.perf_counter() - t_phase:.2f} s")
    return total


# Phase 19: the image-NPPC line. The shipped configs' width
# (configs/image_restoration.yaml, configs/image_nppc.yaml): ImageUNet 32 ->
# 128, bottleneck 256, over MNIST's 1 x 28 x 28 padded to 32, batch 64, 5
# directions, on synthetic digits (the repository holds no IDX files); the
# line's largest net, build_restoration_net's res_unet (64 -> 256,
# bottleneck 512, attention at 16 x 16) over 3 x 256 x 256 under
# inpainting_2's mask, and the res_cnn pre-net NPPC under super_resolution_1
# (3 x 64 x 64 in, 256 x 256 out), batch 4. Random weights from a numpy seed
# in the JAX layout (convert.random_image_net_params).
IMAGE_BATCH, IMAGE_STEPS = 64, 5
IMAGE_LARGE_BATCH, IMAGE_LARGE_STEPS, IMAGE_LARGE_SIZE = 4, 6, 256
# the shipped configs' blocks, as JSON (no PyYAML on the card's machine)
IMAGE_REST_TRAIN = {"dataset": "mnist", "distortion_type": "denoising_1",
                    "net_type": "unet", "loss_type": "mse", "lr": 0.0001}
IMAGE_NPPC_TRAIN = {"net_type": "unet", "n_dirs": 5, "lr": 0.0001,
                    "second_moment_loss_lambda": 0.1,
                    "second_moment_loss_grace": 200}
IMAGE_RUN = {"n_steps": 2000, "batch_size": 64, "benchmark_every": 200}
# the CLI's run: --steps 4, a benchmark every 2 steps, so best/ is written
IMAGE_CLI_STEPS, IMAGE_CLI_BENCHMARK = 4, 2
# the layouts' rounds, each of 10 steps on a trainer built in its layout
IMAGE_LAYOUTS = ("NCHW", "channels-last", "channels-last", "NCHW") * 2
IMAGE_LAYOUT_STEPS = 10


class _ImageModule:
    """An in-memory data module of `n` seeded uniform images [C, H, W]
    (mean .5, std .5, as the CelebA modules)."""
    mean = 0.5
    std = 0.5

    def __init__(self, shape, n, seed):
        self.shape = shape
        arr = np.random.default_rng(seed).uniform(
            size=(n,) + shape).astype(np.float32)
        self.train_set = self.valid_set = self.test_set = list(arr)


def _random_net(net, seed):
    from generative_audio_torch.utils import convert
    net.load_state_dict(convert.convert_image_net(
        convert.random_image_net_params(net, seed), net))


def _image_pair(dm, distortion, net_type, pre_net, seed):
    """(restoration model, NPPC model) on the CPU with numpy-made weights:
    the restoration net from `seed`, the PC net from seed + 1, the pre-net
    from seed + 2."""
    from generative_audio_torch.models import (
        ImageNPPCConfig, ImageNPPCModel, ImageRestorationConfig,
        ImageRestorationModel)
    rest = ImageRestorationModel(ImageRestorationConfig(
        distortion_type=distortion, net_type=net_type), data_module=dm)
    _random_net(rest.base_net, seed)
    nppc = ImageNPPCModel(ImageNPPCConfig(n_dirs=5, pre_net_type=pre_net),
                          rest)
    _load_pc(nppc.wrapper, seed)
    return rest, nppc


def _load_pc(wrapper, seed):
    _random_net(wrapper.net, seed + 1)
    if wrapper.pre_net is not None:
        _random_net(wrapper.pre_net, seed + 2)


def _image_card_vs_cpu(dev, what, make, x, seed):
    """Restored images and directions of the same x_distorted (drawn on the
    CPU), the card (TF32 and strict float32) against the float32 CPU; the
    card's directions orthogonal. The directions take the CPU's x_restored
    on both sides."""
    from generative_audio_torch.utils.device import conv_tf32
    cpu_rest, cpu_nppc = make()
    card_rest, card_nppc = make()
    card_rest.to(dev)
    card_nppc.to(dev)
    x_d = cpu_rest.distort(x, torch.Generator().manual_seed(seed))
    got = {}
    with torch.no_grad():
        want_r = cpu_rest.restore(x_d)
        want_w = cpu_nppc.get_dirs(x_d, want_r)
        for tf32 in (True, False):
            with conv_tf32(tf32):
                got[tf32] = (card_rest.restore(x_d.to(dev)).cpu(),
                             card_nppc.get_dirs(x_d.to(dev),
                                                want_r.to(dev)).cpu())
    rel = {tf32: (_rel(r.numpy(), want_r.numpy()),
                  _rel(w.numpy(), want_w.numpy()))
           for tf32, (r, w) in got.items()}
    off = _unit_gram_off(got[True][1])
    log(f"{what}: card vs CPU (float32) max|err|/peak, TF32: restored "
        f"{rel[True][0]:.3e}, w_mat {rel[True][1]:.3e}; strict float32: "
        f"restored {rel[False][0]:.3e}, w_mat {rel[False][1]:.3e}; largest "
        f"|<w_i, w_j>| of the card's unit directions {off:.3e}")
    check(got[True][1].shape == want_w.shape and all(
        torch.isfinite(t).all() for pair in got.values() for t in pair),
        f"{what}: finite, shaped")
    check(max(rel[True] + rel[False]) < PATH_REL,
          f"{what}: card vs CPU within {PATH_REL} of the peak")
    check(off < NPPC_ORTHO_ABS,
          f"{what}: the card's directions orthogonal within {NPPC_ORTHO_ABS}")


def _image_grads(model, loss, what, compare):
    """loss() and its gradients with TF32 convolutions and, where `compare`,
    in strict float32 on the same weights and inputs: every gradient finite
    and non-zero, and the TF32 gap under phase 17's limits."""
    from generative_audio_torch.utils.device import conv_tf32
    out = {}
    for tf32 in ((True, False) if compare else (True,)):
        with conv_tf32(tf32):
            value = loss()
            value.backward()
        out[tf32] = (value.item(), _grads(model))
        model.zero_grad(set_to_none=True)
    l_tf, g_tf = out[True]
    n_params = sum(1 for p in model.parameters() if p.requires_grad)
    check(len(g_tf) == n_params and all(
        torch.isfinite(g).all() and g.abs().max() > 0 for g in g_tf.values()),
        f"{what}: every gradient finite and non-zero ({len(g_tf)} of "
        f"{n_params} tensors)")
    if not compare:
        return
    l_32, g_32 = out[False]
    top = max(g.norm().item() for g in g_32.values())
    cos, ratio = [], []
    for k, g in g_32.items():
        if g.norm().item() > 1e-3 * top:
            cos.append(torch.nn.functional.cosine_similarity(
                g_tf[k].flatten(), g.flatten(), dim=0).item())
            ratio.append(g_tf[k].norm().item() / g.norm().item())
    loss_rel = abs(l_tf - l_32) / abs(l_32)
    log(f"{what}: TF32 vs float32 on the card: loss {l_tf:.6f} vs "
        f"{l_32:.6f} (rel {loss_rel:.3e}); over {len(cos)} of {len(g_32)} "
        f"gradient tensors cosine >= {min(cos):.6f}, norm ratio "
        f"{min(ratio):.5f}-{max(ratio):.5f}")
    check(loss_rel < INPAINT_TF32_LOSS_REL and min(cos) > INPAINT_TF32_COS
          and max(abs(r - 1) for r in ratio) < INPAINT_TF32_RATIO,
          f"{what}: TF32 within {INPAINT_TF32_LOSS_REL} (loss), "
          f"{INPAINT_TF32_COS} (cosine) and {INPAINT_TF32_RATIO} (norms) of "
          f"float32")


def _image_steps(trainer, batch, n, what, card):
    """n train_step calls on one batch: (ms of each, the median of steps
    2..n); logs samples/s and the peak memory."""
    ms, median, peak, loss = _timed_steps(lambda: trainer.train_step(batch),
                                          n)
    log(f"{what}, batch {len(batch)}: steps "
        f"{' '.join(f'{x:.2f}' for x in ms)} ms, median of 2-{n} "
        f"{median:.2f} ms, {len(batch) * 1e3 / median:.1f} samples/s, peak "
        f"memory {peak:.2f} GiB; last loss {loss.item():.5f}; on {card}")
    check(np.isfinite(loss.item()) and trainer.state.step == n,
          f"{what}: {n} steps, finite loss")
    return median


def _x_batch(dm, n):
    return np.stack([np.asarray(dm.train_set[i % len(dm.train_set)])
                     for i in range(n)])


def _image_large(dev, card):
    """The line's largest nets at 256 x 256: card vs CPU on one item, the
    TF32 gap of the loss and gradients at batch 4, three steps at batch 4."""
    from generative_audio_torch.train import (
        ImageNPPCTrainer, ImageRestorationTrainer)
    size = IMAGE_LARGE_SIZE
    dm = _ImageModule((3, size, size), IMAGE_LARGE_BATCH, SEED + 90)
    x = torch.from_numpy(_x_batch(dm, IMAGE_LARGE_BATCH))
    _image_card_vs_cpu(dev, "res_unet restoration + unet NPPC, inpainting_2, "
                       f"1 x 3 x {size} x {size}",
                       lambda: _image_pair(dm, "inpainting_2", "res_unet",
                                           "none", SEED + 91), x[:1], SEED)
    _image_card_vs_cpu(dev, "unet restoration + res_cnn pre-net NPPC, "
                       f"super_resolution_1, 1 x 3 x {size // 4} x "
                       f"{size // 4} -> {size}",
                       lambda: _image_pair(dm, "super_resolution_1", "unet",
                                           "res_cnn", SEED + 94), x[:1], SEED)
    rest, _ = _image_pair(dm, "inpainting_2", "res_unet", "none", SEED + 91)
    trainer = ImageRestorationTrainer(rest.config, model=rest, seed=SEED,
                                      device=dev)
    xd = x.to(dev)
    x_d = rest.distort(xd)
    _image_grads(trainer.state.model, lambda: trainer.loss_value(xd, x_d),
                 f"res_unet restoration at batch {IMAGE_LARGE_BATCH}",
                 compare=True)
    batch = _x_batch(dm, IMAGE_LARGE_BATCH)
    large = {"res_unet restoration": _image_steps(
        trainer, batch, IMAGE_LARGE_STEPS,
        f"res_unet restoration training, inpainting_2, 3 x {size} x {size}",
        card)}
    _profile(lambda: trainer.train_step(batch),
             f"res_unet restoration training step, batch {IMAGE_LARGE_BATCH}")
    del trainer, rest
    rest, nppc_model = _image_pair(dm, "super_resolution_1", "unet",
                                   "res_cnn", SEED + 94)
    nppc = ImageNPPCTrainer(nppc_model.config, rest, seed=SEED, device=dev)
    _load_pc(nppc.model.wrapper, SEED + 94)
    x_d, x_r = nppc.process_batch(xd, torch.Generator(
        device=dev).manual_seed(SEED))
    _image_grads(nppc.state.model,
                 lambda: nppc.objective(xd, x_d, x_r, 0)[0],
                 f"res_cnn pre-net NPPC at batch {IMAGE_LARGE_BATCH}",
                 compare=True)
    large["res_cnn NPPC"] = _image_steps(
        nppc, _x_batch(dm, IMAGE_LARGE_BATCH), IMAGE_LARGE_STEPS,
        f"res_cnn pre-net NPPC training, super_resolution_1, {size // 4} -> "
        f"{size}", card)
    del nppc, rest
    torch.cuda.empty_cache()
    return large


def _image_training(dev, card):
    """ImageRestorationTrainer and ImageNPPCTrainer at the shipped configs'
    width, batch 64: every gradient finite and non-zero, five steps each
    (ms, samples/s, peak memory), a profile of one step each, the frozen
    restoration net bit for bit unchanged."""
    from generative_audio_torch.models import (
        ImageNPPCConfig, ImageRestorationConfig)
    from generative_audio_torch.train import (
        ImageNPPCTrainer, ImageRestorationTrainer)
    from generative_audio_torch.utils.config import build_dataclass
    trainer = ImageRestorationTrainer(
        build_dataclass(ImageRestorationConfig, IMAGE_REST_TRAIN), seed=SEED,
        device=dev)
    _random_net(trainer.model.base_net, SEED + 95)
    dm = trainer.model.data_module
    batch = _x_batch(dm, IMAGE_BATCH)
    xd = torch.from_numpy(batch).to(dev)
    x_d = trainer.model.distort(xd, torch.Generator(device=dev).manual_seed(
        SEED))
    _image_grads(trainer.state.model, lambda: trainer.loss_value(xd, x_d),
                 f"unet restoration at batch {IMAGE_BATCH}", compare=True)
    ms = {"restoration": _image_steps(
        trainer, batch, IMAGE_STEPS, "unet restoration training, "
        "denoising_1, 1 x 28 x 28", card)}
    _profile(lambda: trainer.train_step(batch),
             f"image restoration training step, batch {IMAGE_BATCH}")
    nppc = ImageNPPCTrainer(build_dataclass(ImageNPPCConfig,
                                            IMAGE_NPPC_TRAIN),
                            trainer.model, seed=SEED, device=dev)
    _load_pc(nppc.model.wrapper, SEED + 95)
    frozen = {k: v.clone() for k, v in
              trainer.model.wrapper.state_dict().items()}
    x_d, x_r = nppc.process_batch(xd, torch.Generator(
        device=dev).manual_seed(SEED))
    _image_grads(nppc.state.model,
                 lambda: nppc.objective(xd, x_d, x_r, 0)[0],
                 f"unet NPPC at batch {IMAGE_BATCH}", compare=True)
    ms["nppc"] = _image_steps(nppc, batch, IMAGE_STEPS,
                              "unet NPPC training, 5 directions", card)
    _profile(lambda: nppc.train_step(batch),
             f"image NPPC training step, batch {IMAGE_BATCH}, 5 directions")
    same = all(torch.equal(v, frozen[k]) for k, v in
               trainer.model.wrapper.state_dict().items())
    log(f"image NPPC: the frozen restoration net bit for bit unchanged: "
        f"{same}")
    check(same and all(p.grad is None for p in
                       trainer.model.wrapper.parameters()),
          "the frozen restoration net bit for bit unchanged, without "
          "gradient")
    score = nppc.benchmark(batch_size=IMAGE_BATCH)
    check(0 <= score <= 1, f"NPPC benchmark (mean reconst_err) {score:.5f} "
          f"in [0, 1]")
    return ms, dm


def _image_layouts(dev, dm, card):
    """The restoration step at batch 64 and the res_unet step at batch 4 in
    both layouts, NCHW (the port's) and channels-last (the trainer's
    weights converted, so cuDNN convolves NHWC from the first conv on), in
    the rounds of IMAGE_LAYOUTS on one card: the median ms of steps 2..n of
    each round."""
    from generative_audio_torch.models import (
        ImageRestorationConfig, ImageRestorationModel)
    from generative_audio_torch.train import ImageRestorationTrainer
    size = IMAGE_LARGE_SIZE
    large = _ImageModule((3, size, size), IMAGE_LARGE_BATCH, SEED + 90)
    cases = {f"unet restoration, batch {IMAGE_BATCH}": (
                 dm, "denoising_1", "unet", IMAGE_BATCH),
             f"res_unet restoration, batch {IMAGE_LARGE_BATCH}": (
                 large, "inpainting_2", "res_unet", IMAGE_LARGE_BATCH)}
    readings = {}
    for what, (module, distortion, net_type, n) in cases.items():
        times = {"NCHW": [], "channels-last": []}
        for layout in IMAGE_LAYOUTS:
            model = ImageRestorationModel(ImageRestorationConfig(
                distortion_type=distortion, net_type=net_type),
                data_module=module)
            _random_net(model.base_net, SEED + 96)
            trainer = ImageRestorationTrainer(model.config, model=model,
                                              seed=SEED, device=dev)
            if layout == "channels-last":
                trainer.state.model.to(memory_format=torch.channels_last)
            batch = _x_batch(module, n)
            _, median, _, _ = _timed_steps(
                lambda: trainer.train_step(batch), IMAGE_LAYOUT_STEPS)
            times[layout].append(median)
            del trainer, model
        readings[what] = times
        log(f"layout, {what}: NCHW "
            f"{' '.join(f'{t:.2f}' for t in times['NCHW'])} ms (median "
            f"{statistics.median(times['NCHW']):.2f}), channels-last "
            f"{' '.join(f'{t:.2f}' for t in times['channels-last'])} ms "
            f"(median {statistics.median(times['channels-last']):.2f}) a "
            f"step, each round's median of steps 2-{IMAGE_LAYOUT_STEPS}; on "
            f"{card}")
    torch.cuda.empty_cache()
    return readings


def _image_cli(dev, card):
    """cli.train's image_restoration line with configs/image_restoration.yaml
    (as JSON) for 4 steps with a benchmark every 2, then the image_nppc line
    with configs/image_nppc.yaml over the first run's directory: latest/,
    best/ and report.html with its grids for both."""
    from generative_audio_torch.cli import train as train_cli
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        run = {**IMAGE_RUN, "benchmark_every": IMAGE_CLI_BENCHMARK}
        cfgs = {"rest": {"line": "image_restoration",
                         "checkpoint_dir": str(root / "rest"),
                         "train": IMAGE_REST_TRAIN, "run": run},
                "nppc": {"line": "image_nppc",
                         "checkpoint_dir": str(root / "nppc"),
                         "restoration_checkpoint": str(root / "rest"),
                         "restoration": {k: IMAGE_REST_TRAIN[k] for k in (
                             "dataset", "distortion_type", "net_type")},
                         "train": IMAGE_NPPC_TRAIN, "run": run}}
        walls = {}
        trainers = {}
        for name, cfg in cfgs.items():
            (root / f"{name}.json").write_text(json.dumps(cfg, indent=1))
            t0 = time.perf_counter()
            trainers[name] = train_cli.main(
                ["-C", str(root / f"{name}.json"), "--steps",
                 str(IMAGE_CLI_STEPS)])
            walls[name] = time.perf_counter() - t0
        latest = torch.load(root / "rest" / "latest.pt", map_location="cpu",
                            weights_only=True)["params"]
        frozen = trainers["nppc"].restoration_model.wrapper.state_dict()
        from_latest = all(torch.equal(frozen[k].cpu(), v)
                          for k, v in latest.items())
        files = {}
        for name, grids in (("rest", 3), ("nppc", 1)):
            d = root / name
            html = (d / "report.html").read_text()
            files[name] = (sorted(p.name for p in d.iterdir()),
                           html.count("data:image/png;base64,"))
            check((d / "latest.pt").exists() and (d / "best.pt").exists()
                  and files[name][1] == grids and "<svg" in html,
                  f"the {name} run wrote latest.pt, best.pt and report.html "
                  f"with {grids} image grid(s) and its SVG curve")
    rest, nppc = trainers["rest"], trainers["nppc"]
    log(f"image CLI, {IMAGE_CLI_STEPS} steps at batch {run['batch_size']}, a "
        f"benchmark every {IMAGE_CLI_BENCHMARK}: restoration losses "
        f"{[round(v, 5) for v in rest.loss_history]} (best "
        f"{rest.best_score:.5f}), {walls['rest']:.1f} s; NPPC objectives "
        f"{[round(v, 5) for v in nppc.loss_history]} (best "
        f"{nppc.best_score:.5f}), {walls['nppc']:.1f} s; the frozen net is "
        f"the restoration run's latest: {from_latest}; files {files}; on "
        f"{card}")
    check(rest.state.step == nppc.state.step == IMAGE_CLI_STEPS
          and np.isfinite(rest.loss_history + nppc.loss_history).all(),
          "both image lines ran their steps, finite losses")
    check(from_latest, "image_nppc froze the restoration run's latest")


def phase_image(dev):
    """Phase 19: the image-NPPC line. No scan kernel is on its path: every
    count of ops.lstm.launch_counts stays 0 through phase 19."""
    from generative_audio_torch.data import MNISTDataModule
    from generative_audio_torch.ops import lstm as L
    t_phase = time.perf_counter()
    card = card_line()
    L.reset_launch_counts()
    mnist = MNISTDataModule()
    x = torch.from_numpy(_x_batch(mnist, IMAGE_BATCH))
    _image_card_vs_cpu(dev, "unet restoration + unet NPPC, denoising_1, "
                       f"{IMAGE_BATCH} x 1 x 28 x 28",
                       lambda: _image_pair(mnist, "denoising_1", "unet",
                                           "none", SEED + 97), x, SEED)
    large = _image_large(dev, card)
    ms, dm = _image_training(dev, card)
    layouts = _image_layouts(dev, dm, card)
    _image_cli(dev, card)
    launched = {k: v for k, v in L.launch_counts.items() if v}
    log(f"scan kernel launches in phase 19: {launched or 0}")
    check(not launched, "no scan kernel launched on the image line")
    log(f"phase 19: {json.dumps({'ms_per_step': {**ms, **large}, 'layouts_ms': layouts})}")
    log(f"phase 19: {time.perf_counter() - t_phase:.2f} s")


# ------------------------------------------------------------- phase 20 --
# Multi-GPU training on the one card. (a) NCCL, a world of one, through
# cli.launch: DDP_STEPS DDP steps of EnhanceTrainer at EnhanceTrainConfig()'s
# full width, bit for bit the plain trainer's on the same seeded weights and
# batch, then cli.train's enhance line on phase 15's corpus for
# DDP_CLI_STEPS steps and -R. (b) gloo, 2 ranks sharing the card, the
# global batch of 18 (9 rows a rank: rank 1's first row is global row 9,
# drop_band group 1): the first step's global loss and the averaged
# gradient against one process on the card. (c) gloo, 2 ranks: the
# restoration line at configs/inpainting_*.yaml's width (batch 128, 64 a
# rank), strict float32: DDP_REST_STEPS steps, the BatchNorm running
# statistics and the losses against one process.
# (b)'s limits: bf16 at other row counts per launch (9 rows of the
# sub-band LSTM's batch against 18) may sum in another order. Measured on
# an NVIDIA H100 80GB HBM3, 700.00 W (first run): (b) step-1 loss 2.13e-7
# relative, cosine 0.999998, norm 4.08e-4; (c) losses 2.17e-5 relative,
# running statistics 6.71e-5.
DDP_STEPS, DDP_CLI_STEPS, DDP_REST_STEPS = 3, 2, 2
DDP_LOSS_REL, DDP_GRAD_COS, DDP_GRAD_NORM_REL = 5e-3, 0.99, 0.05
DDP_BN_ABS, DDP_REST_LOSS_REL = 5e-4, 1e-4
DDP_TIMEOUT = 600          # seconds for a launch, its ranks included
DDP_BATCH_SEED, DDP_REST_SEED = SEED + 20, SEED + 34


def _ddp_launch(part, out, nprocs, backend, per_device=1, mode="--phase20"):
    """cli.launch of this script's `mode part out` in a session of its
    own (so that a launch past its time is killed whole); returns the
    Popen, its output going to out/part.log."""
    import os
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "generative_audio_torch.cli.launch",
           "--nprocs", str(nprocs), "--backend", backend]
    if per_device > 1:
        cmd += ["--ranks-per-device", str(per_device)]
    cmd += ["--", sys.executable, str(root / "chip_smoke.py"), mode,
            part, str(out)]
    env = dict(os.environ, GAT_TIMEOUT="300", PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    with open(out / f"{part}.log", "w") as f:
        return subprocess.Popen(cmd, cwd=str(root), env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _ddp_wait(proc, out, part):
    """Wait for a launch (killing its session past DDP_TIMEOUT); print its
    output; fail on a non-zero exit."""
    import os
    import signal
    try:
        proc.wait(timeout=DDP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    text = (out / f"{part}.log").read_text()
    for line in text.splitlines():
        if "hostname of the client socket" not in line:
            log(f"  [{part}] {line}")
    check(proc.returncode == 0, f"the {part} launch exited 0 "
          f"(got {proc.returncode})")


def _ddp_step_counts(trainer, batch, steps, L):
    """`steps` train_epoch calls on one batch: (losses, ms of each, the
    launches of each)."""
    losses, ms, launches = [], [], []
    for _ in range(steps):
        L.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch([batch]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: v for k, v in L.launch_counts.items() if v})
    return losses, ms, launches


def _first_step_grads(trainer):
    """The gradient apply_gradients finds at its first call (averaged over
    the ranks under DDP), on the CPU in float64."""
    grads = {}
    apply = trainer.state.apply_gradients

    def spy():
        if not grads:
            grads.update({k: p.grad.detach().double().cpu() for k, p in
                          trainer.state.model.named_parameters()
                          if p.grad is not None})
        apply()
    trainer.state.apply_gradients = spy
    return grads


def _strict_float32(trainer_module):
    """The restoration trainer's convolutions in full float32 (its
    train_step turns cuDNN's TF32 on)."""
    import functools
    from generative_audio_torch.utils.device import conv_tf32
    return mock.patch.object(trainer_module, "conv_tf32",
                             functools.partial(conv_tf32, False))


def _restoration_trainer(dev, mesh=None):
    from generative_audio_torch.train import (
        RestorationTrainConfig, RestorationTrainer)
    from generative_audio_torch.utils import convert
    from generative_audio_torch.utils.config import build_dataclass
    sd = convert.convert_inpainting_nppc(convert.random_inpainting_nppc_params(
        _inpaint_config().model, seed=SEED + 30))
    trainer = RestorationTrainer(
        build_dataclass(RestorationTrainConfig, INPAINT_REST_TRAIN),
        seed=SEED, device=dev, mesh=mesh)
    trainer.state.model.load_state_dict(
        {k[len("pretrained_restoration_model."):]: v for k, v in sd.items()
         if k.startswith("pretrained_restoration_model.")})
    return trainer


def _restoration_steps(trainer):
    """DDP_REST_STEPS strict float32 steps on the seeded batch: (the global
    losses, the running statistics on the CPU)."""
    from generative_audio_torch.parallel.mesh import mean_over_ranks
    from generative_audio_torch.train import restoration
    batch = _inpaint_batch(DDP_REST_SEED, INPAINT_BATCH)
    with _strict_float32(restoration):
        losses = [trainer.train_step(batch) for _ in range(DDP_REST_STEPS)]
    losses = mean_over_ranks(torch.stack(losses), trainer.mesh).tolist()
    stats = {k: v.detach().cpu() for k, v in
             trainer.state.model.state_dict().items() if "running" in k}
    return losses, stats


def ddp_worker(part, out):
    """A rank of phase 20's launches (run by cli.launch)."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.parallel import distributed as D
    from generative_audio_torch.parallel import make_mesh
    from generative_audio_torch.train import EnhanceTrainer
    out = Path(out)
    check(D.initialize(), "the launcher's environment starts the job")
    dev = D.local_device("cuda")
    mesh = make_mesh(device_type="cuda")
    rank = D.process_index()
    plus = model_paths()[0]
    cfg = plus.train_config("bfloat16")
    result = {"rank": rank, "world": D.process_count(),
              "backend": torch.distributed.get_backend(), "device": str(dev)}
    if part == "nccl":
        from generative_audio_torch.cli import train as train_cli
        batch = tuple(torch.from_numpy(x).to(dev) for x in
                      _noise_batch(DDP_BATCH_SEED, TRAIN_BATCH,
                                   TRAIN_SAMPLES))
        runs = {}
        for name, m in (("plain", None), ("ddp", mesh)):
            trainer = EnhanceTrainer(cfg, seed=SEED,
                                     pretrained_state_dict=plus.sd,
                                     device=dev, mesh=m)
            losses, ms, launches = _ddp_step_counts(trainer, batch,
                                                    DDP_STEPS, L)
            runs[name] = (losses, ms, launches, trainer.state.model)
            result[name] = {"losses": losses, "ms": ms,
                            "launches": launches,
                            "net": type(trainer.net).__name__}
        result["bitwise"] = (runs["plain"][0] == runs["ddp"][0] and all(
            torch.equal(a, b) for a, b in zip(
                runs["plain"][3].state_dict().values(),
                runs["ddp"][3].state_dict().values())))
        del runs
        torch.cuda.empty_cache()
        cli = []
        for extra in ([], ["-R"]):
            L.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = train_cli.main(["-C", str(out / "train.json"),
                                      "--steps", str(DDP_CLI_STEPS)] + extra)
            cli.append({"step": trainer.state.step,
                        "latest_step": trainer.ckpt.latest_step(),
                        "mesh": trainer.mesh is not None,
                        "losses": trainer.loss_history,
                        "seconds": time.perf_counter() - t0,
                        "launches": {k: v for k, v in
                                     L.launch_counts.items() if v}})
            del trainer
        result["cli"] = cli
    else:
        trainer = EnhanceTrainer(cfg, seed=SEED, pretrained_state_dict=plus.sd,
                                 device=dev, mesh=mesh)
        grads = _first_step_grads(trainer)
        batch = _noise_batch(DDP_BATCH_SEED, TRAIN_BATCH, TRAIN_SAMPLES)
        losses, ms, launches = _ddp_step_counts(trainer, batch, 2, L)
        result["enhance"] = {"losses": losses, "ms": ms,
                             "launches": launches}
        if rank == 0:
            torch.save(grads, out / "grads.pt")
        del trainer, grads
        torch.cuda.empty_cache()
        trainer = _restoration_trainer(dev, mesh)
        t0 = time.perf_counter()
        losses, stats = _restoration_steps(trainer)
        result["restoration"] = {"losses": losses,
                                 "seconds": time.perf_counter() - t0}
        if rank == 0:
            torch.save(stats, out / "stats.pt")
    (out / f"{part}_rank{rank}.json").write_text(json.dumps(result))
    D.shutdown()
    return 0


def phase_multi_gpu(dev, plus):
    """Phase 20 (see DDP_* above); returns the ranks' scan launches, which
    the kernels line adds to the main path's, and (b)'s single-process
    reference: {"loss", "grads"} of FullSubNet+'s first step on the seeded
    batch."""
    check(torch.distributed.is_available()
          and torch.distributed.is_nccl_available(),
          "torch.distributed with NCCL on this machine")
    from generative_audio_torch.train import EnhanceTrainer
    t_phase = time.perf_counter()
    card = card_line()
    launched = dict.fromkeys((*C_ENTRIES, *D_ENTRIES), 0)
    per_step = routed_step(plus.per_step)
    # (a)'s cli.train steps: phase 15's corpus batch
    cli_step = routed_step(plus.per_step, CORPUS_BATCH * TRAIN_ROWS
                           // TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        data, _, _, _, _ = _write_corpus(out / "corpus")
        cfg = json.loads(_train_config(out, data, None).read_text())
        cfg["checkpoint_dir"] = str(out / "ckpt_ddp")
        (out / "train.json").write_text(json.dumps(cfg))
        t_part = time.perf_counter()
        proc = _ddp_launch("nccl", out, 1, "nccl")
        _ddp_wait(proc, out, "nccl")
        log(f"phase 20: corpus {t_part - t_phase:.1f} s, (a)'s launch "
            f"{time.perf_counter() - t_part:.1f} s")
        t_part = time.perf_counter()
        a = json.loads((out / "nccl_rank0.json").read_text())
        log(f"phase 20 (a) NCCL world of one on {a['device']} "
            f"(backend {a['backend']}, {a['world']} rank): DDP losses "
            f"{a['ddp']['losses']}, plain {a['plain']['losses']}; ms a step "
            f"DDP {' '.join(f'{x:.1f}' for x in a['ddp']['ms'])}, plain "
            f"{' '.join(f'{x:.1f}' for x in a['plain']['ms'])} (phase 6: "
            f"{STEP_MS.get('FullSubNet+', float('nan')):.2f}); on {card}")
        check(a["backend"] == "nccl" and a["world"] == 1
              and a["ddp"]["net"] == "DistributedDataParallel",
              "(a) ran under NCCL, one rank, through DDP")
        check(a["bitwise"], f"(a) {DDP_STEPS} DDP steps bit for bit the "
              "plain trainer's (losses, parameters, buffers)")
        for run in ("plain", "ddp"):
            check(all(c == per_step for c in a[run]["launches"]),
                  f"(a) {run}: {per_step} a step (got "
                  f"{a[run]['launches']})")
        for i, run in enumerate(a["cli"]):
            log(f"phase 20 (a) cli.train{' -R' if i else ''}: step "
                f"{run['step']}, latest_step.json {run['latest_step']}, "
                f"losses {run['losses']}, launches {run['launches']}, "
                f"{run['seconds']:.1f} s")
            check(run["mesh"] and run["step"] == run["latest_step"]
                  == DDP_CLI_STEPS * (i + 1)
                  and np.isfinite(run["losses"]).all(),
                  f"(a) cli.train run {i + 1} under DDP at step "
                  f"{DDP_CLI_STEPS * (i + 1)}")
            check(run["launches"] == {k: v * DDP_CLI_STEPS for k, v in
                                      cli_step.items()},
                  f"(a) cli.train run {i + 1}: {cli_step} a step")
        for k in launched:
            launched[k] += sum(c.get(k, 0) for c in a["ddp"]["launches"]) + \
                sum(run["launches"].get(k, 0) for run in a["cli"])

        proc = _ddp_launch("gloo", out, 2, "gloo", per_device=2)
        try:
            # one process on the card meanwhile, on the same weights and
            # batches
            ref = EnhanceTrainer(plus.train_config("bfloat16"), seed=SEED,
                                 pretrained_state_dict=plus.sd, device=dev)
            ref_grads = _first_step_grads(ref)
            ref_loss = ref.train_epoch([_noise_batch(
                DDP_BATCH_SEED, TRAIN_BATCH, TRAIN_SAMPLES)])
            del ref
            torch.cuda.empty_cache()
            rest = _restoration_trainer(dev)
            ref_rest, ref_stats = _restoration_steps(rest)
            del rest
            torch.cuda.empty_cache()
        finally:
            _ddp_wait(proc, out, "gloo")
        log(f"phase 20: (b, c)'s launch with the single-process references "
            f"{time.perf_counter() - t_part:.1f} s")
        ranks = [json.loads((out / f"gloo_rank{r}.json").read_text())
                 for r in (0, 1)]
        grads = torch.load(out / "grads.pt", weights_only=True)
        stats = torch.load(out / "stats.pt", weights_only=True)
    check(all(r["backend"] == "gloo" and r["world"] == 2
              and r["device"] == str(dev) for r in ranks),
          "(b, c) two gloo ranks on the one card")
    # each rank's sub-band model over its 9 clips' rows
    rank_step = routed_step(plus.per_step, TRAIN_ROWS // 2)
    for r in ranks:
        check(all(c == rank_step for c in r["enhance"]["launches"]),
              f"(b) rank {r['rank']}: {rank_step} a step (got "
              f"{r['enhance']['launches']})")
        for k in launched:
            launched[k] += sum(c.get(k, 0) for c in r["enhance"]["launches"])
    loss = ranks[0]["enhance"]["losses"][0]
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    cos, norm_rel, a_norm, b_norm = _grads_vs(grads, ref_grads)
    log(f"phase 20 (b) gloo, 2 ranks x 9 rows on the card against one "
        f"process x 18: step-1 loss {loss:.6f} vs {ref_loss:.6f} (rel "
        f"{loss_rel:.2e}, limit {DDP_LOSS_REL:g}); averaged gradient cosine "
        f"{cos:.6f} (limit {DDP_GRAD_COS}), norm {a_norm:.5f} vs "
        f"{b_norm:.5f} (rel {norm_rel:.2e}, limit "
        f"{DDP_GRAD_NORM_REL}); ms a step (2 ranks sharing the card) "
        f"{ranks[0]['enhance']['ms']}; on {card}")
    check(loss_rel <= DDP_LOSS_REL, "(b) step-1 loss within the limit")
    check(cos >= DDP_GRAD_COS and norm_rel <= DDP_GRAD_NORM_REL,
          "(b) averaged gradient within the limits")
    got_rest = ranks[0]["restoration"]["losses"]
    rest_rel = max(abs(g - w) / abs(w) for g, w in zip(got_rest, ref_rest))
    bn = max((stats[k].double() - v.double()).abs().max().item()
             for k, v in ref_stats.items())
    log(f"phase 20 (c) gloo, 2 ranks x 64 rows, restoration line strict "
        f"float32: losses {got_rest} vs {ref_rest} (rel {rest_rel:.2e}, "
        f"limit {DDP_REST_LOSS_REL:g}); BatchNorm running statistics "
        f"max |diff| {bn:.2e} (limit {DDP_BN_ABS:g}) over {len(ref_stats)} "
        f"tensors; {ranks[0]['restoration']['seconds']:.1f} s for "
        f"{DDP_REST_STEPS} steps; on {card}")
    check(sorted(stats) == sorted(ref_stats) and bn <= DDP_BN_ABS,
          "(c) BatchNorm statistics within the limit")
    check(rest_rel <= DDP_REST_LOSS_REL, "(c) losses within the limit")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s; ranks' scan "
        f"launches {launched}")
    return launched, {"loss": ref_loss, "grads": ref_grads}


def _grads_vs(grads, ref_grads):
    """(cosine, |norm ratio - 1|, norm, reference norm) of a gradient
    against a reference, both {name: float64 tensor on the CPU} over the
    same names."""
    check(sorted(grads) == sorted(ref_grads), "the same gradients")
    a = torch.cat([grads[k].flatten() for k in sorted(ref_grads)])
    b = torch.cat([ref_grads[k].flatten() for k in sorted(ref_grads)])
    a_norm, b_norm = float(a.norm()), float(b.norm())
    return (float(a @ b) / (a_norm * b_norm), abs(a_norm / b_norm - 1),
            a_norm, b_norm)


# Phase 21: the band axis (make_mesh(data, band), subband_sharding) on the
# one card, gloo ranks sharing it: (a) data=1 x band=2, FullSubNet+ and then
# v1-GRU, BAND_STEPS steps each; (b) data=2 x band=2, FullSubNet+,
# BAND_STEPS steps. The global batch is phase 20's (DDP_BATCH_SEED, 18 x
# 3.072 s), so (b)'s data groups hold 9 rows each and FullSubNet+'s 2304
# sub-band rows split into 1152 a rank in (a), 576 in (b). Each rank's
# step-1 scan launches are recorded and held against the plain versions in
# the rank (phases 3 and 10's limits), after the step's launches are
# counted. The limits against one process are phase 20's (b)'s.
BAND_STEPS = 2
BAND_PARTS = {"band_a": (1, 2, ("plus", "v1_gru")), "band_b": (2, 2, ("plus",))}


def _sub_band_rows(path):
    """The sub-band model's rows in a training step on phase 20's batch:
    the batch times the bins drop_band keeps a row."""
    cfg = path.train_config("bfloat16")
    model = cfg.model_v1 if cfg.model_type == "fullsubnet" else cfg.model
    return TRAIN_BATCH * (model.num_freqs // model.num_groups_in_drop_band)


@contextlib.contextmanager
def _band_collective_events():
    """While open, CUDA events around every forward and backward of the
    split and the gather (parallel.distributed's _SplitRows and
    _GatherRows); yields the list of (start, end) pairs they append to."""
    from generative_audio_torch.parallel import distributed as D
    events = []

    def timed(fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events.append((start, end))
            return out
        return staticmethod(run)

    with contextlib.ExitStack() as stack:
        for cls in (D._SplitRows, D._GatherRows):
            for name in ("forward", "backward"):
                stack.enter_context(mock.patch.object(
                    cls, name, timed(getattr(cls, name))))
        yield events


def _state_digest(module):
    """sha256 of every parameter's and buffer's bytes, in state-dict
    order."""
    import hashlib
    digest = hashlib.sha256()
    for t in module.state_dict().values():
        digest.update(t.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    return digest.hexdigest()


def _band_steps(trainer, path, batch, L, G, what):
    """BAND_STEPS steps of a band trainer: each one's loss, ms, launches
    and ms inside the split and the gather, the rows of each sub-band model
    call; step 1's scan launches recorded and, after the counts are read,
    held on their operands against the plain versions."""
    rows = []
    hook = trainer.state.model.sb_model.register_forward_pre_hook(
        lambda module, args: rows.append(args[0].shape[0]))
    lstm = path.fwd.startswith("lstm")
    steps = []
    for step in range(BAND_STEPS):
        L.reset_launch_counts()
        record = ((_recorded_scans(L) if lstm else _recorded_calls(
            G, fwd="gru_scan_tm", bwd="gru_scan_bwd_tm")) if step == 0
            else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record as recorded, _band_collective_events() as events:
            loss = trainer.train_epoch([batch])
            torch.cuda.synchronize()
        steps.append({
            "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: v for k, v in L.launch_counts.items() if v},
            "collective_ms": sum(a.elapsed_time(b) for a, b in events),
            "collectives": len(events)})
        if step == 0:
            calls = recorded
    hook.remove()
    if lstm:
        launch_rows = [out[0].shape[1] for _, out in calls["C"]]
        dev = next(trainer.state.model.parameters()).device
        _scans_vs_plain(L, dev, calls, what, len(calls["C"]))
    else:
        launch_rows = [out.shape[1] for _, out in calls["fwd"]]
        _forward_scans_vs_plain(calls["fwd"], what)
        _gru_bwd_vs_plain(calls["bwd"], what)
    return {"steps": steps, "sb_rows": rows, "launch_rows": launch_rows}


def band_worker(part, out):
    """A rank of phase 21's launches (run by cli.launch)."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.parallel import distributed as D
    from generative_audio_torch.parallel import make_mesh, subband_sharding
    from generative_audio_torch.train import EnhanceTrainer
    out = Path(out)
    check(D.initialize(), "the launcher's environment starts the job")
    dev = D.local_device("cuda")
    data, band, runs = BAND_PARTS[part]
    mesh = make_mesh(data, band, device_type="cuda")
    rank = D.process_index()
    sharding = subband_sharding(mesh)
    plus, v1_gru, _ = model_paths()
    batch = _noise_batch(DDP_BATCH_SEED, TRAIN_BATCH, TRAIN_SAMPLES)
    result = {"rank": rank, "world": D.process_count(),
              "backend": torch.distributed.get_backend(), "device": str(dev),
              "band": [sharding.index, sharding.size]}
    for name in runs:
        path = plus if name == "plus" else v1_gru
        trainer = EnhanceTrainer(path.train_config("bfloat16"), seed=SEED,
                                 pretrained_state_dict=path.sd, device=dev,
                                 mesh=mesh)
        check(trainer.subband_sharding == sharding,
              "the trainer takes subband_sharding(mesh)")
        grads = _first_step_grads(trainer)
        result[name] = _band_steps(trainer, path, batch, L, G,
                                   f"{name} on band rank {sharding.index} "
                                   f"of mesh {data}x{band}")
        result[name]["digest"] = _state_digest(trainer.state.model)
        if rank == 0:
            torch.save(grads, out / f"{part}_{name}_grads.pt")
        del trainer, grads
        torch.cuda.empty_cache()
    (out / f"{part}_rank{rank}.json").write_text(json.dumps(result))
    D.shutdown()
    return 0


def _band_reference(dev, path, batch):
    """One process's first step on the card: {"loss", "grads"}."""
    from generative_audio_torch.train import EnhanceTrainer
    ref = EnhanceTrainer(path.train_config("bfloat16"), seed=SEED,
                         pretrained_state_dict=path.sd, device=dev)
    grads = _first_step_grads(ref)
    loss = ref.train_epoch([batch])
    del ref
    torch.cuda.empty_cache()
    return {"loss": loss, "grads": grads}


def phase_band_axis(dev, plus, v1_gru, plus_ref):
    """Phase 21 (see BAND_* above). plus_ref: phase 20's single-process
    reference on the same weights and batch. Returns the ranks' scan
    launches, which the kernels line adds to the main path's."""
    t_phase = time.perf_counter()
    card = card_line()
    paths = {"plus": plus, "v1_gru": v1_gru}
    launched = dict.fromkeys(list(plus.per_step) + list(v1_gru.per_step)
                             + list(C_ENTRIES) + list(D_ENTRIES)
                             + list(GRU_FWD_ENTRIES)
                             + list(GRU_BWD_ENTRIES), 0)
    refs = {"plus": plus_ref}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        results = {}
        for part, (data, band, runs) in BAND_PARTS.items():
            nprocs = data * band
            t_part = time.perf_counter()
            proc = _ddp_launch(part, out, nprocs, "gloo", per_device=nprocs,
                               mode="--phase21")
            try:
                if "v1_gru" in runs and "v1_gru" not in refs:
                    # one process on the card meanwhile
                    refs["v1_gru"] = _band_reference(dev, v1_gru, _noise_batch(
                        DDP_BATCH_SEED, TRAIN_BATCH, TRAIN_SAMPLES))
            finally:
                _ddp_wait(proc, out, part)
            log(f"phase 21 {part}: launch {time.perf_counter() - t_part:.1f} "
                "s")
            results[part] = (
                [json.loads((out / f"{part}_rank{r}.json").read_text())
                 for r in range(nprocs)],
                {name: torch.load(out / f"{part}_{name}_grads.pt",
                                  weights_only=True) for name in runs})
    for part, (ranks, grads) in results.items():
        data, band, runs = BAND_PARTS[part]
        nprocs = data * band
        check(all(r["backend"] == "gloo" and r["world"] == nprocs
                  and r["device"] == str(dev)
                  and r["band"] == [r["rank"] % band, band] for r in ranks),
              f"{part}: {nprocs} gloo ranks on the one card, rank r at band "
              "index r % band")
        for name in runs:
            share = _sub_band_rows(paths[name]) // nprocs
            per_step = routed_step(paths[name].per_step, share)
            for r in ranks:
                run = r[name]
                check(all(s["launches"] == per_step for s in run["steps"]),
                      f"{part} {name} rank {r['rank']}: {per_step} a step "
                      f"(got {[s['launches'] for s in run['steps']]})")
                check(run["sb_rows"] == [share] * BAND_STEPS,
                      f"{part} {name} rank {r['rank']}: the sub-band model "
                      f"over {share} rows a step (got {run['sb_rows']})")
                for k in launched:
                    launched[k] += sum(s["launches"].get(k, 0)
                                       for s in run["steps"])
            digests = {r[name]["digest"] for r in ranks}
            check(len(digests) == 1, f"{part} {name}: every rank's "
                  f"parameters bit for bit equal after {BAND_STEPS} steps")
            loss = ranks[0][name]["steps"][0]["loss"]
            ref = refs[name]
            loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
            cos, norm_rel, _, _ = _grads_vs(grads[name], ref["grads"])
            for r in ranks:
                run = r[name]
                log(f"phase 21 {part} {name} rank {r['rank']} (band index "
                    f"{r['band'][0]} of {band}, data group "
                    f"{r['rank'] // band} of {data}): rows per scan launch "
                    f"{run['launch_rows']}; losses "
                    f"{[s['loss'] for s in run['steps']]}; ms a step "
                    f"{[round(s['ms'], 1) for s in run['steps']]} (step 1 "
                    f"with the records' copies); split and gather "
                    f"{[round(s['collective_ms'], 2) for s in run['steps']]} "
                    f"ms over {[s['collectives'] for s in run['steps']]} "
                    f"calls, {100 * run['steps'][-1]['collective_ms'] / run['steps'][-1]['ms']:.1f}% "
                    f"of step {BAND_STEPS}; {nprocs} ranks sharing {card}")
            log(f"phase 21 {part} {name} against one process: step-1 loss "
                f"{loss:.6f} vs {ref['loss']:.6f} (rel {loss_rel:.2e}, limit "
                f"{DDP_LOSS_REL:g}); gradient cosine {cos:.6f} (limit "
                f"{DDP_GRAD_COS}), norm rel {norm_rel:.2e} (limit "
                f"{DDP_GRAD_NORM_REL}); on {card}")
            check(loss_rel <= DDP_LOSS_REL,
                  f"{part} {name}: step-1 loss within the limit")
            check(cos >= DDP_GRAD_COS and norm_rel <= DDP_GRAD_NORM_REL,
                  f"{part} {name}: the gradient within the limits")
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s; ranks' scan "
        f"launches {launched}")
    return launched



# Phase 22: the float32 compute mode, the JAX models' default dtype, at full
# width. A float32 model on the card runs its recurrent layers on the mixed
# route of nn.recurrent (bf16 gates from the fp32-accumulated projection plus
# the fp32 bias, the scan kernels with float32 output) and the rest in
# strict float32 (utils.device.resolve_device turns TF32 off). (a) a 10 s
# request and a 30 s request under LONG_CLIP_GATES_LIMIT (kernel B) of
# FullSubNet+ against the float32 model on the CPU, kernels A and B held on
# their operands, and the 10 s request's ms beside bf16's; (b)
# TRAIN_STEPS EnhanceTrainer steps at 18 x 3.072 s, kernels C and D held on
# their operands, step 1 against the bf16 step and 4 x 1 s against the CPU;
# (c) a v1-GRU step and a chunked 10 s v1-GRU request (the GRU rows); (d)
# an NPPCDenoisingTrainer step at its default dtype, 4 x 1 s against the
# CPU; (e) __graft_entry__.dryrun_multichip's configuration (a narrow
# FullSubNet+, its 8 x 4096-sample batch) over 2 gloo ranks of
# make_mesh(1, 2) sharing the card against one process; (f) the three
# examples as subprocesses on the card. (e) and (f) run while this process
# holds the paths against the CPU; the timed parts come after them.
F32_REQUESTS = 3              # timed 10 s requests of each mode
F32_TIMED_STEPS = 3           # timed steps after step 1 in (c) and (d)
F32_V1_SECONDS = 10           # the chunked v1-GRU request
GRAFT_MODEL = {"num_freqs": 32, "sb_num_neighbors": 3,
               "fb_model_hidden_size": 32, "sb_model_hidden_size": 16,
               "num_groups_in_drop_band": 2}
GRAFT_BATCH, GRAFT_SAMPLES = 8, 4096
EXAMPLES = ("enhance_demo", "streaming_demo", "nppc_inpainting_demo")
EXAMPLE_TIMEOUT = 300


def _graft_config():
    """__graft_entry__.dryrun_multichip's EnhanceTrainConfig (float32)."""
    from generative_audio_torch.models import FullSubNetPlusConfig
    from generative_audio_torch.train import EnhanceTrainConfig
    return EnhanceTrainConfig(model=FullSubNetPlusConfig(**GRAFT_MODEL),
                              n_fft=62, hop_length=32, win_length=62,
                              compute_dtype="float32")


def _graft_batch():
    """Its batch at 8 devices (data 4 x band 2): 2 rows a data group."""
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((GRAFT_BATCH, GRAFT_SAMPLES)).astype(
        np.float32) for _ in range(2))


@contextlib.contextmanager
def _tf32(enabled):
    """cuBLAS's and cuDNN's float32 with TF32 (enabled) or strict inside."""
    from generative_audio_torch.utils.device import conv_tf32
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        with conv_tf32(enabled):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _wall_ms(fn, n):
    """Median wall ms of n synchronised calls of fn after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _carry_scans_vs_plain(calls, what):
    """Kernel B's or the GRU carry kernel's results on the very operands a
    chunked forward handed lstm_scan_carry_tm or gru_scan_carry_tm (as
    _recorded_calls records them): the h sequence and the state after the
    chunk against the plain versions on the card, under phase 2's and phase
    9's limits. The same limits must reject each h sequence with its rows
    rolled by one."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    worst = [0.0, 0.0]
    for i, (args, out) in enumerate(calls):
        if len(out) == 3:           # LSTM: (gates, w_hh, h0, c0, reverse, dt)
            kernel, mean_limit = "kernel B", KERNEL_MEAN_ABS
            want = L.lstm_scan_carry_reference_tm(
                args[0].to(torch.bfloat16), *args[1:])
        else:                       # GRU: (gates, w_hh, b_hh, h0, reverse, dt)
            kernel, mean_limit = "GRU carry", GRU_FWD_MEAN_ABS
            want = G.gru_scan_carry_reference_tm(
                args[0].to(torch.bfloat16), *args[1:])

        def within(seq):
            err = (seq.float() - want[0].float()).abs()
            return (err.max().item(), err.mean().item(),
                    err.max().item() < KERNEL_MAX_ABS
                    and err.mean().item() < mean_limit)
        max_e, mean_e, ok = within(out[0])
        state = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(out[1:], want[1:]))
        faulty = within(out[0].roll(1, 1))
        worst = [max(worst[0], max_e), max(worst[1], mean_e)]
        check(torch.isfinite(out[0]).all().item() and ok
              and state < KERNEL_MAX_ABS * max(1.0, C_PEAK),
              f"{kernel} vs plain on {what}, chunk {i + 1} within "
              f"{KERNEL_MAX_ABS}/{mean_limit} (state {state:.3e})")
        check(not faulty[2], f"the {kernel} limits reject rows rolled by 1 "
              f"({what}, chunk {i + 1})")
    log(f"{kernel} on {what}: {len(calls)} chunks (T={calls[0][1][0].shape[0]}"
        f" rows={calls[0][1][0].shape[1]} H={calls[0][1][0].shape[2]}, "
        f"{calls[0][1][0].dtype} out), each within the limits and rejecting "
        f"rows rolled by 1: worst max|err| {worst[0]:.3e}, mean {worst[1]:.3e}")


def _f32_requests(dev, plus, v1_gru, counts, card):
    """(a) and (c)'s requests, each against the float32 model on the CPU
    within PATH_REL, every scan launch held on its operands against its
    plain version, the scans' output float32: FullSubNet+ at full width, a
    10 s request (2 kernel A launches) and a 30 s request under
    LONG_CLIP_GATES_LIMIT (kernel B); FullSubNet v1-GRU, a 10 s request
    whose sub-band GRU takes the carry kernel under that limit (the full
    band: the forward). Returns their launches."""
    from generative_audio_torch.nn import recurrent as R
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.ops import lstm as L
    check([layer.route(dev) for layer in
           plus.model(torch.float32, dev).sb_model.sequence_model.layers]
          == ["mixed", "mixed"], "the float32 sub-band LSTM takes the mixed "
          "route on the card")
    rng = np.random.default_rng(SEED + 80)
    launched = {}
    for path, seconds, limit, fwd_name, carry_name, module in (
            (plus, 10, None, "lstm_scan_tm", "lstm_scan_carry_tm", L),
            (plus, 30, LONG_CLIP_GATES_LIMIT, "lstm_scan_tm",
             "lstm_scan_carry_tm", L),
            (v1_gru, F32_V1_SECONDS, LONG_CLIP_GATES_LIMIT, "gru_scan_tm",
             "gru_scan_carry_tm", G)):
        wav = (rng.standard_normal(seconds * 16000) * 0.1).astype(np.float32)
        inf = path.inferencer(path.model(torch.float32, dev,
                                         gates_bytes_limit=limit), dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with _recorded_calls(R, fwd=fwd_name) as fwd, \
                _recorded_calls(module, carry=carry_name) as carry:
            before = dict(counts)
            out = inf.enhance(wav)
            got = _launched(counts, before)
        # with the records' copies of the operands
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        n_carry = len(carry["carry"])
        # under the gates limit v1's forwards are its full band's
        want = {k: n for k, n in ((routed(path.fwd, ROWS // 8, True)
                                   if limit is None or not path.fb_forward
                                   else routed(path.fwd, 1, True, FB_HIDDEN),
                                   len(fwd["fwd"])),
                                  (routed(path.carry, ROWS // 8, True),
                                   n_carry)) if n}
        what = f"the float32 {path.name} {seconds} s request"
        n_fwd = path.per_forward if limit is None else path.per_long_forward
        check(got == want and len(fwd["fwd"]) == n_fwd
              and (limit is None) == (n_carry == 0),
              f"{what} launched {n_fwd} {path.fwd} and, above the gates "
              f"limit only, {path.carry} (got {got})")
        check(all(o.dtype == torch.float32 for _, o in fwd["fwd"])
              and all(o[0].dtype == torch.float32 for _, o in carry["carry"]),
              f"{what}: the scans return float32")
        if fwd["fwd"]:
            _forward_scans_vs_plain(fwd["fwd"], what)
        if n_carry:
            _carry_scans_vs_plain(carry["carry"], what)
        del fwd, carry, inf
        for k, n in got.items():
            launched[k] = launched.get(k, 0) + n
        ref = path.inferencer(path.model(torch.float32, "cpu"), "cpu")
        rel = _rel(out, ref.enhance(wav))
        log(f"phase 22 {what}: launched {got}, peak memory {peak:.2f} GiB "
            f"with the records; against float32 on the CPU: max|err|/peak "
            f"{rel:.3e} on {card}")
        check(out.shape == wav.shape and np.isfinite(out).all()
              and rel < PATH_REL,
              f"{what} vs float32 on the CPU within {PATH_REL}")
    torch.cuda.empty_cache()
    return launched


def _f32_request_times(dev, plus, card):
    """(a)'s readings: a 10 s FullSubNet+ request's wall ms in float32
    (strict, the port's choice), in bf16 and in float32 with TF32, in two
    alternating rounds, and TF32's distance from strict float32."""
    m32 = plus.model(torch.float32, dev)
    inf32 = plus.inferencer(m32, dev)
    inf16 = plus.inferencer(plus.model(torch.bfloat16, dev), dev)
    wav = (np.random.default_rng(SEED + 82).standard_normal(10 * 16000)
           * 0.1).astype(np.float32)
    ms = {"float32": [], "bf16": [], "float32 TF32": []}
    for _ in range(2):
        ms["float32"].append(_wall_ms(lambda: inf32.enhance(wav),
                                      F32_REQUESTS))
        ms["bf16"].append(_wall_ms(lambda: inf16.enhance(wav), F32_REQUESTS))
        with _tf32(True):
            ms["float32 TF32"].append(_wall_ms(lambda: inf32.enhance(wav),
                                               F32_REQUESTS))
    strict = inf32.enhance(wav)
    with _tf32(True):
        loose = inf32.enhance(wav)
    log(f"phase 22 (a) 10 s request, median wall ms of {F32_REQUESTS} in two "
        f"alternating rounds: float32 (strict, the port's) {ms['float32']}, "
        f"bf16 {ms['bf16']}, float32 with TF32 {ms['float32 TF32']}; TF32 "
        f"vs strict max|err|/peak {_rel(loose, strict):.3e}; on {card}")
    # a batch of 8 x 10 s: the hoisted float32 route's memory and time
    from generative_audio_torch.ops import prepare_input_from_waveform
    batch = torch.from_numpy(np.random.default_rng(SEED + 83).standard_normal(
        (8, 160000)).astype(np.float32) * 0.1).to(dev)
    inputs = prepare_input_from_waveform(batch, 512, 256, 512)[:plus.n_inputs]
    line = []
    with torch.inference_mode():
        for name, model in (("float32", m32), ("bf16", inf16.model)):
            model(*inputs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            out = model(*inputs)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
            check(torch.isfinite(out).all().item(),
                  f"the {name} batch-8 x 10 s forward is finite")
            del out
            line.append(f"{name} {cuda_ms(lambda: model(*inputs), 3):.2f} ms, "
                        f"{peak:.2f} GiB above its inputs")
    log(f"phase 22 (a) batch 8 x 10 s forward: {'; '.join(line)}; on {card}")
    del m32, inf32, inf16, inputs, batch
    torch.cuda.empty_cache()


def _f32_training(dev, plus, counts, card):
    """(b): TRAIN_STEPS EnhanceTrainer steps of FullSubNet+ at
    compute_dtype "float32" on phase 6's batch: exact launches, kernels C
    and D of step 1 on their operands, every parameter's gradient, step 1's
    loss and gradient against the bf16 trainer's on the same weights and
    batch, the ms beside phase 6's, a profile of one step."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import EnhanceTrainer
    batch = tuple(torch.from_numpy(x).to(dev) for x in
                  _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    ref = EnhanceTrainer(plus.train_config("bfloat16"), seed=SEED,
                         pretrained_state_dict=plus.sd, device=dev)
    ref_grads = _first_step_grads(ref)
    ref_loss = ref.train_epoch([batch])
    del ref
    trainer = EnhanceTrainer(plus.train_config("float32"), seed=SEED,
                             pretrained_state_dict=plus.sd, device=dev)
    check(trainer.state.model.compute_dtype == torch.float32,
          "EnhanceTrainConfig(compute_dtype='float32') builds a float32 model")
    grads = _first_step_grads(trainer)
    verify = _first_grads(trainer.state.model.named_parameters(),
                          "float32 parameter")
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    per_step = routed_step(plus.per_step)
    total = dict.fromkeys(per_step, 0)
    for step in range(TRAIN_STEPS):
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (_recorded_scans(L) if step == 0
              else contextlib.nullcontext()) as recorded:
            losses.append(trainer.train_epoch([batch]))   # ends in a fetch
        times.append((time.perf_counter() - t0) * 1e3)
        got = _launched(counts, before)
        check(got == per_step, f"float32 train step {step + 1} "
              f"launched {per_step} and nothing else (got {got})")
        total = {k: total[k] + got[k] for k in total}
        if step == 0:
            verify()
            _scans_vs_plain(L, dev, recorded,
                            "the float32 FullSubNet+ step's layers", 2)
            del recorded
            # the records held the operands past the step
            torch.cuda.reset_peak_memory_stats(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "float32 training losses finite, the fifth below the first")
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    cos, norm_rel, _, _ = _grads_vs(grads, ref_grads)
    steady = statistics.median(times[1:])
    log(f"phase 22 (b) float32 FullSubNet+ training, batch {TRAIN_BATCH} x "
        f"{TRAIN_SAMPLES / 16000:.3f} s: losses "
        f"{' '.join(f'{x:.5f}' for x in losses)}; ms a step "
        f"{' '.join(f'{x:.1f}' for x in times)}, median of steps "
        f"2-{TRAIN_STEPS} {steady:.2f} ms against bf16's "
        f"{STEP_MS.get(plus.name, float('nan')):.2f} (phase 6), peak memory "
        f"of steps 2-{TRAIN_STEPS} {peak:.2f} GiB; step 1 against the bf16 "
        f"step: loss {losses[0]:.6f} vs {ref_loss:.6f} (rel "
        f"{loss_rel:.3e}), gradient cosine {cos:.6f}, norm rel "
        f"{norm_rel:.3e}; on {card}")
    check(loss_rel < TRAIN_LOSS_REL and cos > TRAIN_GRAD_COS
          and norm_rel < TRAIN_GRAD_RATIO,
          f"float32 step 1 vs bf16: loss within {TRAIN_LOSS_REL}, cosine "
          f"above {TRAIN_GRAD_COS}, norm within {TRAIN_GRAD_RATIO}")
    _profile(lambda: trainer.train_epoch([batch]),
             f"float32 FullSubNet+ training step, batch {TRAIN_BATCH} x "
             f"{TRAIN_SAMPLES / 16000:.3f} s")
    del trainer, grads, ref_grads
    torch.cuda.empty_cache()
    return total


def _f32_v1_gru(dev, v1_gru, counts, card):
    """(c)'s training: FullSubNet v1-GRU in float32, one step on phase 6's
    batch with exact launches, every GRU launch held on its operands (the
    forward and the backward), a second step's ms beside phase 6's bf16."""
    from generative_audio_torch.ops import gru as G
    from generative_audio_torch.train import EnhanceTrainer
    batch = tuple(torch.from_numpy(x).to(dev) for x in
                  _noise_batch(SEED + 6, TRAIN_BATCH, TRAIN_SAMPLES))
    trainer = EnhanceTrainer(v1_gru.train_config("float32"), seed=SEED,
                             pretrained_state_dict=v1_gru.sd, device=dev)
    verify = _first_grads(trainer.state.model.named_parameters(),
                          "float32 v1-GRU parameter")
    per_step = routed_step(v1_gru.per_step)
    with _recorded_calls(G, fwd="gru_scan_tm", bwd="gru_scan_bwd_tm") as rec:
        losses = [_count(counts, lambda: trainer.train_epoch([batch]),
                         per_step, "float32 v1-GRU train step 1")]
    verify()
    what = "the float32 v1-GRU step"
    check(len(rec["fwd"]) == 4 and len(rec["bwd"]) == 4,
          f"{what}: 4 GRU forwards and 4 backwards")
    _forward_scans_vs_plain(rec["fwd"], what)
    _gru_bwd_vs_plain(rec["bwd"], what)
    del rec
    times = []
    for step in range(2, F32_TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_count(counts, lambda: trainer.train_epoch([batch]),
                             per_step, f"float32 v1-GRU train step {step}"))
        times.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(losses).all(), "float32 v1-GRU losses finite")
    del trainer
    log(f"phase 22 (c) float32 v1-GRU training: losses "
        f"{' '.join(f'{x:.5f}' for x in losses)}; steps 2-"
        f"{F32_TIMED_STEPS + 1} {' '.join(f'{x:.1f}' for x in times)} ms, "
        f"median {statistics.median(times):.2f} against bf16's "
        f"{STEP_MS.get(v1_gru.name, float('nan')):.2f} (phase 6) on {card}")
    torch.cuda.empty_cache()
    return {k: (F32_TIMED_STEPS + 1) * n for k, n in per_step.items()}


def _f32_nppc(dev, cfg, params, counts, card):
    """(d): NPPCDenoisingTrainer at its default compute dtype (float32, the
    JAX line's), phase 16's configuration, weights and batch: exact
    launches (kernel A for the frozen enhancer, C and D for the head), C
    and D of step 1 on their operands, a finite objective, step 2's ms
    beside phase 16's bf16."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.train import NPPCDenoisingTrainer
    from generative_audio_torch.utils import convert
    trainer = NPPCDenoisingTrainer(
        _nppc_train_config(cfg),
        restoration_params=params["pretrained_restoration_model"],
        seed=SEED, device=dev)
    trainer.state.model.audio_pc_wrapper.net.load_state_dict(
        convert.convert_multidirection(params["audio_pc_wrapper"]["net"]))
    model = trainer.state.model
    check(model.pretrained_restoration_model.compute_dtype == torch.float32
          and model.audio_pc_wrapper.net.compute_dtype == torch.float32,
          "NPPCDenoisingTrainer's default dtype is float32")
    noisy, clean = (torch.from_numpy(x).to(dev) for x in
                    _noise_batch(SEED + 22, NPPC_BATCH, NPPC_SAMPLES))
    per_step = routed_counts(("lstm_scan_fwd", NPPC_BATCH * ROWS // 8, 2,
                              True),
                             ("lstm_scan_fwd_train", NPPC_HEAD_ROWS, 2),
                             ("lstm_scan_bwd", NPPC_HEAD_ROWS, 2))
    verify = _first_grads(model.audio_pc_wrapper.named_parameters(),
                          "float32 head")
    with _recorded_scans(L) as recorded:
        obj = _count(counts, lambda: trainer.train_step(noisy, clean)[0],
                     per_step, "float32 nppc step 1").item()
    verify()
    _scans_vs_plain(L, dev, recorded, "the float32 nppc head's layers", 2)
    del recorded
    objectives, times = [obj], []
    for step in range(2, F32_TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        objectives.append(_count(
            counts, lambda: trainer.train_step(noisy, clean)[0], per_step,
            f"float32 nppc step {step}").item())            # a fetch
        times.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(objectives).all(), "float32 nppc objectives finite")
    log(f"phase 22 (d) nppc_denoising at its default float32: objectives "
        f"{' '.join(f'{x:.6f}' for x in objectives)}; steps 2-"
        f"{F32_TIMED_STEPS + 1} {' '.join(f'{x:.1f}' for x in times)} ms, "
        f"median {statistics.median(times):.2f} against bf16's "
        f"{STEP_MS.get('nppc', float('nan')):.2f} (phase 16), batch "
        f"{NPPC_BATCH} x {NPPC_SAMPLES / 16000:.3f} s, on {card}")
    del trainer, model
    torch.cuda.empty_cache()
    return {k: (F32_TIMED_STEPS + 1) * n for k, n in per_step.items()}


def graft_worker(out):
    """A rank of phase 22 (e) (run by cli.launch): one float32 EnhanceTrainer
    step of __graft_entry__'s configuration on make_mesh(1, 2); kernels C
    and D on their operands after the step's launches are read."""
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.parallel import distributed as D
    from generative_audio_torch.parallel import make_mesh
    from generative_audio_torch.train import EnhanceTrainer
    out = Path(out)
    check(D.initialize(), "the launcher's environment starts the job")
    dev = D.local_device("cuda")
    mesh = make_mesh(1, 2, device_type="cuda")
    rank = D.process_index()
    trainer = EnhanceTrainer(_graft_config(), seed=SEED, device=dev,
                             mesh=mesh)
    check(trainer.state.model.compute_dtype == torch.float32,
          "the graft configuration trains in float32")
    grads = _first_step_grads(trainer)
    L.reset_launch_counts()
    with _recorded_scans(L) as calls:
        loss = trainer.train_epoch([_graft_batch()])
        torch.cuda.synchronize()
    launches = {k: v for k, v in L.launch_counts.items() if v}
    rows = [o[0].shape[1] for _, o in calls["C"]]
    _scans_vs_plain(L, dev, calls, f"the graft band step on rank {rank}",
                    len(calls["C"]))
    result = {"rank": rank, "world": D.process_count(),
              "backend": torch.distributed.get_backend(), "loss": loss,
              "band": [trainer.subband_sharding.index,
                       trainer.subband_sharding.size],
              "launches": launches, "rows": rows, "step": trainer.state.step,
              "digest": _state_digest(trainer.state.model)}
    if rank == 0:
        torch.save(grads, out / "graft_grads.pt")
    (out / f"graft_rank{rank}.json").write_text(json.dumps(result))
    D.shutdown()
    return 0


def _examples(root, out):
    """(f): each example's module on the card in a session of its own, its
    output to out/<name>.log; returns the Popens."""
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = {}
    for name in EXAMPLES:
        with open(out / f"{name}.log", "w") as f:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"generative_audio_torch.examples.{name}"],
                cwd=str(root), env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
    return procs


def _graft_reference(dev, counts):
    """(e)'s one process: the graft configuration's first float32 step on
    the card, {"loss", "grads", "launched"}."""
    from generative_audio_torch.train import EnhanceTrainer
    ref = EnhanceTrainer(_graft_config(), seed=SEED, device=dev)
    grads = _first_step_grads(ref)
    before = dict(counts)
    loss = ref.train_epoch([_graft_batch()])
    return {"loss": loss, "grads": grads,
            "launched": _launched(counts, before)}


def _graft_and_examples_check(out, procs, ref, card):
    """(e) and (f) after their processes ended: each example exited 0 (its
    last lines printed), and the ranks' step against the one process's.
    Returns the launches of (e), the ranks' and the one process's."""
    for name, proc in procs.items():
        for line in (out / f"{name}.log").read_text().splitlines()[-8:]:
            log(f"  [{name}] {line}")
        check(proc.returncode == 0, f"the example {name} exited 0 on the "
              f"card (got {proc.returncode})")
    ranks = [json.loads((out / f"graft_rank{r}.json").read_text())
             for r in range(2)]
    grads = torch.load(out / "graft_grads.pt", weights_only=True)
    rows = GRAFT_BATCH * (GRAFT_MODEL["num_freqs"]
                          // GRAFT_MODEL["num_groups_in_drop_band"])

    def per_step(n):        # the step's scans over n sub-band rows, routed
        return routed_counts(*((k, n, 2, False,
                                GRAFT_MODEL["sb_model_hidden_size"])
                               for k in ("lstm_scan_fwd_train",
                                         "lstm_scan_bwd")))

    check(ref["launched"] == per_step(rows),
          f"the graft step in one process launched {per_step(rows)} (got "
          f"{ref['launched']})")
    check(all(r["backend"] == "gloo" and r["world"] == 2 and r["step"] == 1
              and r["band"] == [r["rank"], 2]
              and r["launches"] == per_step(rows // 2)
              and r["rows"] == [rows // 2] * 2 for r in ranks),
          f"(e) 2 gloo ranks at band index r of 2, {per_step(rows // 2)} "
          f"each over "
          f"{rows // 2} of the {rows} sub-band rows (got "
          f"{[(r['band'], r['launches'], r['rows']) for r in ranks]})")
    check(ranks[0]["digest"] == ranks[1]["digest"],
          "(e) both ranks' parameters bit for bit equal after the step")
    loss_rel = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    cos, norm_rel, _, _ = _grads_vs(grads, ref["grads"])
    log(f"phase 22 (e) the graft configuration's float32 step over 2 band "
        f"ranks against one process: loss {ranks[0]['loss']:.6f} vs "
        f"{ref['loss']:.6f} (rel {loss_rel:.2e}, limit {DDP_LOSS_REL:g}), "
        f"gradient cosine {cos:.6f} (limit {DDP_GRAD_COS}), norm rel "
        f"{norm_rel:.2e} (limit {DDP_GRAD_NORM_REL}); on {card}")
    check(loss_rel <= DDP_LOSS_REL and cos >= DDP_GRAD_COS
          and norm_rel <= DDP_GRAD_NORM_REL,
          "(e) the band step within phase 20's limits of one process")
    return {k: sum(r["launches"].get(k, 0) for r in ranks) + n
            for k, n in ref["launched"].items()}


def phase_float32(dev, plus, v1_gru):
    """Phase 22 (see above). Returns the launches of its paths by kernel
    (this process's and the ranks' of (e); not the comparisons)."""
    import os
    import signal
    from generative_audio_torch.ops import lstm as L
    from generative_audio_torch.utils import convert
    t_phase = time.perf_counter()
    card = card_line()
    counts = L.launch_counts
    root = Path(__file__).resolve().parent
    nppc_cfg = nppc_config()
    nppc_params = convert.random_denoising_nppc_params(nppc_cfg,
                                                       seed=SEED + 20)
    total = {}

    def add(launched):
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n

    # (e) and (f) run while this process holds the paths against the CPU
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        launch = _ddp_launch("graft", out, 2, "gloo", per_device=2,
                             mode="--phase22")
        procs = _examples(root, out)
        try:
            L.reset_launch_counts()
            add(_f32_requests(dev, plus, v1_gru, counts, card))
            phase_training_reference(dev, plus, "float32")
            _nppc_reference(dev, nppc_cfg, nppc_params, torch.float32)
            L.reset_launch_counts()
            ref = _graft_reference(dev, counts)
        finally:
            for proc in procs.values():
                try:
                    proc.wait(timeout=EXAMPLE_TIMEOUT)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            _ddp_wait(launch, out, "graft")
        add(_graft_and_examples_check(out, procs, ref, card))
    del ref
    log(f"phase 22 against the CPU, with (e) and (f) beside it: "
        f"{time.perf_counter() - t_part:.1f} s")
    # the timed parts, the card to this process alone
    _f32_request_times(dev, plus, card)
    for part in (lambda: _f32_training(dev, plus, counts, card),
                 lambda: _f32_v1_gru(dev, v1_gru, counts, card),
                 lambda: _f32_nppc(dev, nppc_cfg, nppc_params, counts, card)):
        L.reset_launch_counts()
        add(part())
    log(f"launches on the float32 paths of phase 22: {total}")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return total


def main():
    if sys.argv[1:2] == ["--phase20"]:
        return ddp_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--phase21"]:
        return band_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--phase22"]:
        return graft_worker(sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from generative_audio_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    # the native audio library is compiled for the machine it runs on
    # (-march=native) at its first use, in phase 15: a copy built elsewhere
    # goes
    from generative_audio_torch.data import native
    native._LIB.unlink(missing_ok=True)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, {torch.cuda.device_count()} device(s)")
    registers = phase_build()
    from generative_audio_torch.ops import lstm as L
    with L.resident_forwards():     # the resident cluster, the witness
        kernels = phase_kernels(dev, registers)
    # kernels C's and D's resident clusters, likewise
    with L.resident_backwards(), L.resident_forwards():
        kernels.update(phase_train_kernels(dev, registers))
        kernels["lstm_scan_bwd"]["full_band"] = phase_lstm_h512(dev,
                                                                registers)
    phase_padded_hidden(dev)
    block_kernels, block_launches = phase_block_forwards(dev)
    kernels.update(block_kernels)
    stream_kernels, stream_launches = phase_streamed_forwards(dev, registers)
    kernels.update(stream_kernels)
    bwd_stream_kernels, bwd_stream_launches = phase_streamed_backwards(
        dev, registers)
    kernels.update(bwd_stream_kernels)
    staged_kernels, staged_launches = phase_streamed_staged(dev, registers)
    kernels.update(staged_kernels)
    wide_kernels, wide_launches = phase_wide_forwards(dev, registers)
    kernels.update(wide_kernels)
    wide_bwd_kernels, wide_bwd_launches = phase_wide_backward(dev, registers)
    kernels.update(wide_bwd_kernels)
    wide_c_kernels, wide_c_launches = phase_wide_train(dev, registers)
    kernels.update(wide_c_kernels)
    phase_lstm_train_large(dev)
    with L.resident_forwards():     # the GRU's resident cluster, the witness
        kernels.update(phase_gru_kernels(dev))
    with L.resident_backwards(), L.resident_forwards():   # likewise
        kernels.update(phase_gru_train_kernels(dev, registers))
    gru_wide_kernels, gru_wide_launches = phase_gru_wide_backward(dev,
                                                                  registers)
    kernels["gru_scan_bwd_dwhh"].update(gru_wide_kernels.pop(
        "gru_scan_bwd_dwhh"))
    kernels.update(gru_wide_kernels)
    gru_fwd_kernels, gru_fwd_launches = phase_gru_wide_forwards(dev,
                                                                registers)
    kernels.update(gru_fwd_kernels)

    pallas = "generative_audio_tpu/ops/pallas_lstm.py"
    csrc = "generative_audio_torch/csrc"
    table = {       # name: (source, the TPU kernel it replaces)
        "lstm_scan_fwd": (f"{csrc}/lstm_scan.cu", f"{pallas}:142"),
        "lstm_scan_fwd_carry": (f"{csrc}/lstm_scan.cu", f"{pallas}:725"),
        "lstm_scan_fwd_train": (f"{csrc}/lstm_scan.cu", f"{pallas}:205"),
        "lstm_scan_bwd": (f"{csrc}/lstm_scan_bwd.cu", f"{pallas}:300"),
        "gru_scan_fwd": (f"{csrc}/gru_scan.cu", f"{pallas}:907"),
        "gru_scan_fwd_carry": (f"{csrc}/gru_scan.cu", f"{pallas}:1151"),
        "gru_scan_bwd": (f"{csrc}/gru_scan_bwd.cu", f"{pallas}:1019"),
        # the dW_hh line of the same TPU kernel's body
        "gru_scan_bwd_dwhh": (f"{csrc}/gru_scan_bwd.cu", f"{pallas}:1011"),
        # each with an entry point of its own, on no model's path
        "lstm_layer_fwd": (f"{csrc}/lstm_scan_staged.cu", f"{pallas}:542"),
        "lstm_scan_bwd_chains": (f"{csrc}/lstm_scan_bwd_chains.cu",
                                 "scripts/perf_lstm_chains.py:105"),
        "lstm_scan_fwd_unrolled": (f"{csrc}/lstm_scan_staged.cu",
                                   "scripts/perf_lstm_unroll.py:59"),
        # their single-block routes: kernel G where no cluster holds H
        # (its first design), kernel E above H=512
        "lstm_scan_bwd_chains_block": (f"{csrc}/lstm_scan_bwd.cu",
                                       "scripts/perf_lstm_chains.py:105"),
        "lstm_scan_fwd_unrolled_block": (f"{csrc}/lstm_scan_unrolled_block.cu",
                                         "scripts/perf_lstm_unroll.py:59"),
        # the single-block route of rows 1, 5, 2, 6 and 8 where no cluster
        # holds H, on the wrappers' path at such H
        "lstm_scan_fwd_block": (f"{csrc}/lstm_scan_block.cu", f"{pallas}:142"),
        "lstm_scan_fwd_carry_block": (f"{csrc}/lstm_scan_block.cu",
                                      f"{pallas}:725"),
        "lstm_scan_fwd_train_block": (f"{csrc}/lstm_scan_block.cu",
                                      f"{pallas}:205"),
        "gru_scan_fwd_block": (f"{csrc}/gru_scan_block.cu", f"{pallas}:907"),
        "gru_scan_fwd_carry_block": (f"{csrc}/gru_scan_block.cu",
                                     f"{pallas}:1151"),
        # kernel F's single-block route where no cluster holds H
        "lstm_layer_fwd_block": (f"{csrc}/lstm_layer_block.cu",
                                 f"{pallas}:542"),
        # the streamed cluster of rows 1, 5, 2, 6 and 8 where no resident
        # cluster holds H, on the model paths of phase 23
        "lstm_scan_fwd_stream": (f"{csrc}/lstm_scan.cu", f"{pallas}:142"),
        "lstm_scan_fwd_carry_stream": (f"{csrc}/lstm_scan.cu",
                                       f"{pallas}:725"),
        "lstm_scan_fwd_train_stream": (f"{csrc}/lstm_scan.cu",
                                       f"{pallas}:205"),
        "gru_scan_fwd_stream": (f"{csrc}/gru_scan.cu", f"{pallas}:907"),
        "gru_scan_fwd_carry_stream": (f"{csrc}/gru_scan.cu",
                                      f"{pallas}:1151"),
        # the streamed cluster backwards of rows 3 and 7 above H=512 where
        # their model beats the single block's, on the training paths of
        # phases 23 and 24
        "lstm_scan_bwd_stream": (f"{csrc}/scan_bwd_stream.cu",
                                 f"{pallas}:300"),
        "gru_scan_bwd_stream": (f"{csrc}/scan_bwd_stream.cu",
                                f"{pallas}:1019"),
        # kernels F and E as streamed clusters above H=512, on phase 25's
        # path (lstm_layer_tm over the sub-band stacks of the 768- and
        # 1536-unit FullSubNet+; lstm_unrolled and lstm_scan_tm(block_t))
        "lstm_layer_fwd_stream": (f"{csrc}/lstm_staged_stream.cu",
                                  f"{pallas}:542"),
        "lstm_scan_fwd_unrolled_stream": (f"{csrc}/lstm_staged_stream.cu",
                                          "scripts/perf_lstm_unroll.py:59"),
        # kernels A and B as wide clusters, the route at the sub-band batch
        # (phase 26), on the serving paths where the route takes them
        "lstm_scan_fwd_wide": (f"{csrc}/lstm_scan_wide.cu", f"{pallas}:142"),
        "lstm_scan_fwd_carry_wide": (f"{csrc}/lstm_scan_wide.cu",
                                     f"{pallas}:725"),
        # kernel D as a wide cluster, the route at the sub-band training
        # batch (phase 27), on the training paths where the route takes it
        "lstm_scan_bwd_wide": (f"{csrc}/lstm_scan_bwd_wide.cu",
                               f"{pallas}:300"),
        # kernel C as a wide cluster, the route at the sub-band training
        # batch (phase 29), on the training paths where the route takes it
        "lstm_scan_fwd_train_wide": (f"{csrc}/lstm_scan_wide.cu",
                                     f"{pallas}:205"),
        # the GRU backward scan as a wide cluster, the route at v1's
        # sub-band training batch (phase 28), on the v1-GRU training paths
        "gru_scan_bwd_wide": (f"{csrc}/gru_scan_bwd_wide.cu",
                              f"{pallas}:1019"),
        # the GRU forward and carry as wide clusters, the route at v1's
        # sub-band batches (phase 30), on the v1-GRU paths where the route
        # takes them
        "gru_scan_fwd_wide": (f"{csrc}/gru_scan_wide.cu", f"{pallas}:907"),
        "gru_scan_fwd_carry_wide": (f"{csrc}/gru_scan_wide.cu",
                                    f"{pallas}:1151")}
    plus, v1_gru, v1_lstm = model_paths()
    # FullSubNet+'s kernels A and B as the route takes them at one clip's
    # and at the batch's sub-band rows
    plus_ab = {routed("lstm_scan_fwd", ROWS // 8), routed("lstm_scan_fwd", ROWS),
               routed("lstm_scan_fwd_carry", ROWS // 8)}
    counts = dict.fromkeys(L.launch_counts, 0)
    launched, plus_rtf = drive(dev, plus, [*sorted(plus_ab),
                                           routed("lstm_scan_fwd_train",
                                                  TRAIN_ROWS),
                                           routed("lstm_scan_bwd",
                                                  TRAIN_ROWS)])
    # v1-GRU's forwards, carry and backward scans as the route takes them
    # at each call's rows (sub-band and full band)
    v1_kernels = {*forward_counts(v1_gru, 1), *forward_counts(v1_gru, 8),
                  routed("gru_scan_fwd_carry", ROWS // 8),
                  *routed_step(v1_gru.per_step)}
    launched.update(drive(dev, v1_gru, sorted(v1_kernels))[0])
    for name, n in launched.items():
        counts[name] += n
    for name, launched in phase_serving_modes(dev, plus, plus_rtf).items():
        counts[name] += launched
    for name, launched in phase_validation(dev, plus).items():
        counts[name] += launched
    for name, launched in phase_corpus_training(dev).items():
        counts[name] += launched
    for name, launched in phase_nppc_denoising(dev).items():
        counts[name] += launched
    phase_inpainting(dev)
    for name, launched in phase_item5(dev).items():
        counts[name] += launched
    phase_image(dev)
    launched, plus_ref = phase_multi_gpu(dev, plus)
    for name, n in launched.items():
        counts[name] += n
    for name, n in phase_band_axis(dev, plus, v1_gru, plus_ref).items():
        counts[name] += n
    del plus_ref
    for name, n in phase_float32(dev, plus, v1_gru).items():
        counts[name] += n
    counts.update(block_launches)
    counts.update(stream_launches)
    counts.update(staged_launches)
    for name, n in {**wide_launches, **wide_bwd_launches,
                    **gru_wide_launches, **wide_c_launches}.items():
        counts[name] += n
    for name, n in gru_fwd_launches.items():
        counts[name] += n
    for name, n in bwd_stream_launches.items():
        counts[name] += n
    phase_reference(dev, v1_lstm, v1_lstm.model(torch.bfloat16, dev))

    for phase in (lambda: phase_lstm_chains(
                      dev, kernels["lstm_scan_bwd"]["library_ms"], registers),
                  lambda: phase_lstm_unroll(dev, registers)):
        with L.resident_backwards():    # kernel G against D's resident cluster
            numbers, launches = phase()
        kernels.update(numbers)
        counts.update(launches)
    (kernels["lstm_layer_fwd"], counts["lstm_layer_fwd"],
     kernels["lstm_layer_fwd_block"]) = phase_lstm_layer(
        dev, plus, kernels["lstm_scan_fwd"]["ms"], registers)

    print(json.dumps({"kernels": [
        {**kernels[name], "name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[name]}
        for name, (source, replaces) in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
