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
     plain version; then the single-block forwards the wrappers take where
     no cluster holds H: against the clusters bit for bit at LSTM H=512 and
     GRU H=640, every such wrapper at LSTM H=640 and 768 (lstm_layer_tm's
     lstm_layer_fwd_block among them) and GRU H=768 against its plain
     version, and each scan entry's time at H=768; then LSTMScan at H=768
     and 1024 (kernel D's single block, dc in registers) against autograd
     through the float32 recurrence, and kernel D's single block at H=1024
     timed;
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
The launch counts are set to 0 just before each model's serving phases and
read just after, again around each model's five training steps, around
each variant's own path in phase 12 and around phases 13, 14 and 15, each
path of phase 16 and phase 18's model paths (whose launches add to kernel
A's, in phases 14-16 to kernel B's too, in phases 15-16 and 18 to kernels
C's and D's, and in phase 18 to the GRU kernels'), and in each rank of
phase 20 around each DDP step and each cli.train run (whose launches add to
kernels C's and D's). The second-to-last line of stdout is
the `kernels` JSON, the last line the device JSON. Exits non-zero without a
CUDA device. `python3 chip_smoke.py --phase20 PART OUT` is a rank of phase
20, run by cli.launch.
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
# The median ms of phase 6's training steps 2-5 by model, for phase 15.
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
# Hidden sizes no cluster holds (LSTM above 512, GRU above 640): the
# forwards take the single-block route. The GRU runs at the last.
BLOCK_HIDDEN = (640, 768)


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
            **_chains_registers(reports.get("lstm_scan_bwd_chains", ""))}


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


def library_lstm_train_ms(gates, w_hh, gout):
    """cuDNN's LSTM as in library_lstm_ms, in training mode: the forward
    alone (it keeps its reserve space for a backward), and the forward plus
    the backward to the gates and the weights. Timed only."""
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

    return cuda_ms(lambda: lstm(x), iters=5), cuda_ms(both, iters=5)


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
    """LSTMScan (kernel C's and kernel D's single blocks) at H=768 and 1024,
    which no cluster holds (kernel D's single block keeps dc in registers,
    so it holds H up to 1024): both gradients against autograd through the
    float32 recurrence, forward and reverse, with the launches counted
    around it; and kernel D's single block at H=1024 against its plain
    version and timed."""
    from generative_audio_torch.ops import lstm as L
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    t_len, rows = T_CHUNK, 40
    L.reset_launch_counts()
    for h in (BLOCK_HIDDEN[-1], 1024):
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
    check(launches == {"lstm_scan_fwd_train_block": 4, "lstm_scan_bwd": 4},
          "LSTMScan at H=768 and 1024 runs kernel C's and kernel D's single "
          "blocks once a gradient")
    h, t_len, rows = 1024, TRAIN_T, TRAIN_BATCH
    plan = L.card_bwd_scan_plan(dev, h, rows)
    check(plan.design == "block", f"kernel D at H={h} takes its single block")
    w_hh = _uniform(gen, dev, (h, 4 * h), h ** -0.5)
    gates = torch.randn(t_len, rows, 4 * h, generator=gen,
                        device=dev).to(torch.bfloat16)
    gout = torch.randn(t_len, rows, h, generator=gen,
                       device=dev).to(torch.bfloat16)
    h_seq, c_seq = L.lstm_scan_train_tm(gates, w_hh)
    dg = L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh)
    want = L.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout, w_hh)
    err = (dg.float() - want.float()).abs()
    peak = want.float().abs().max().item()
    check(err.max().item() < BWD_MAX_REL * peak
          and err.mean().item() < BWD_MEAN_REL * peak,
          f"kernel D's single block vs plain at H={h}")
    ms = cuda_ms(lambda: L.lstm_scan_bwd_tm(gates, h_seq, c_seq, gout, w_hh),
                 iters=3)
    log(f"kernel D's single block at T={t_len} rows={rows} H={h}: {ms:.3f} ms "
        f"({plan.smem_bytes} B a block, dc in registers); max|err| "
        f"{err.max().item():.3e} mean {err.mean().item():.3e} (peak "
        f"{peak:.3f}) on {card_line()}")


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
    hp, route = L.forward_hidden(h, L.scan_smem_bytes)
    hf, route_f = L.layer_route(h, SB_FEATURES)
    log(f"LSTM {tag}: A max|err| {err_a.max().item():.3e} mean "
        f"{err_a.mean().item():.3e}; B (reverse, from a state) "
        f"{err_b:.3e}; C c_seq {err_c.max().item():.3e}, h == A bitwise "
        f"{torch.equal(h_seq, h_a)}; D "
        f"{err_d.max().item():.3e} mean {err_d.mean().item():.3e} (peak "
        f"{peak:.3f}); F (reverse, F={SB_FEATURES}) "
        f"{err_f.max().item():.3e} mean {err_f.mean().item():.3e}; A-C at "
        f"{hp} units ({'single blocks' if route else 'clusters'}), F at {hf} "
        f"({'single blocks' if route_f else 'clusters'}), D: "
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
    hp, route = G._forward_route(h)
    log(f"GRU {tag}: forward max|err| {err_f.max().item():.3e} mean "
        f"{err_f.mean().item():.3e}; carry (reverse, from h0) "
        f"{err_gc:.3e}; backward dgx {err_g.max().item():.3e} mean "
        f"{err_g.mean().item():.3e} (peak {peak_g:.3f}), dW_hh "
        f"{rel_w:.3e}, db_hh {rel_b:.3e}; forward at {hp} units "
        f"({'single blocks' if route else 'clusters'}), backward: "
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
    the wrappers take where no cluster holds H: bit for bit against the
    cluster entries where both run (LSTM H=512, GRU H=640, forward and
    reverse, bf16 and fp32 out, from a state; kernel F's in phase 12); every
    model-path scan wrapper and lstm_layer_tm at LSTM H=640 and 768 and GRU
    H=768 against its plain version within the kernel limits, with the
    launch counts set to 0 around them; and each scan entry at H=768, T=195,
    18 rows against its plain
    version, with its time beside bound, plain version and cuDNN. Returns
    the entries' numbers for the kernels line and their launches."""
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

    # the route itself: every model-path wrapper where no cluster fits
    L.reset_launch_counts()
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
        check(n > 0, f"{name} launched by the wrappers at an H no cluster "
              f"holds")

    # each entry at H=768, the full-band training shape's T and rows
    h, t_len, rows = BLOCK_HIDDEN[-1], TRAIN_T, TRAIN_BATCH
    card = card_line()
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
    return kernels, launches


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
    plan = G.plan_dwhh(n, h)
    log(f"GRU dW_hh contraction at H={h} over N={n} rows, {plan.tiles} tiles "
        f"x {plan.slices} slices of {plan.rows_per_slice} rows and their sum: "
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
    check(launched == {**dict.fromkeys(launched, 0), "lstm_scan_fwd_train": 1,
                       "lstm_scan_bwd": 1},
          f"LSTMLayerScan launched 1 lstm_scan_fwd_train and 1 lstm_scan_bwd "
          f"and nothing else (got {launched})")
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
    768, which no cluster holds, its single block against
    lstm_scan_fwd_block; against its plain version, and its times beside
    kernel A's (the single block's at H=768 beside lstm_scan_fwd_block),
    with its plans and registers. Returns both entries' numbers and their
    launches on this path."""
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
                got = PU.lstm_unrolled(gates, w, block_t=k)      # the path
                want = L.lstm_scan_tm(gates, w)                  # kernel A
                torch.cuda.synchronize()
                hp, route = L.unrolled_route(h, k)
                expected["lstm_scan_fwd_unrolled" + route] += 1
                a_entry = "lstm_scan_fwd" + L._forward_route(h)[1]
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
        got = PU.lstm_unrolled(gates, w)
        want = PU.lstm_unrolled_reference(gates, w)
        err_blk = (got.float() - want.float()).abs()
        check(err_blk.max().item() < KERNEL_MAX_ABS
              and err_blk.mean().item() < KERNEL_MEAN_ABS,
              f"lstm_scan_fwd_unrolled_block vs plain at H={h}")
        err_blk = err_blk.max().item()
        ms_blk = {k: cuda_ms(lambda k=k: PU.lstm_unrolled(gates, w, block_t=k),
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
            per_forward=4, per_long_forward=2,
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


def phase_serving(dev, path, model, counts):
    inf = path.inferencer(model, dev)
    rng = np.random.default_rng(SEED + 2)
    card = card_line()
    for seconds in (3.0, 7.5, 10.0):
        noisy = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
        before = counts[path.fwd]
        t0 = time.perf_counter()
        out = inf.enhance(noisy)
        wall = (time.perf_counter() - t0) * 1e3
        check(out.shape == noisy.shape and np.isfinite(out).all(),
              f"{path.name} {seconds} s request: shape and finite")
        check(counts[path.fwd] - before == path.per_forward,
              f"{path.fwd} launched {path.per_forward} times per forward")
        log(f"serve {path.name} {seconds} s clip: rtf {inf.last_rtf:.5f}, "
            f"{wall:.2f} ms per call on {card}")

    clips = [((rng.standard_normal(160000) * 0.1).astype(np.float32), f"clip{i}")
             for i in range(8)]
    before = counts[path.fwd]
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
    check(counts[path.fwd] - before == 2 * path.per_forward,
          f"{path.fwd} launched {path.per_forward} times for each of the "
          f"batched forwards (warm-up and request)")
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
    launched_c = counts[path.carry] - before[path.carry]
    check(launched_c > 0
          and counts[path.fwd] - before[path.fwd] == path.per_long_forward,
          f"{path.name}: the 30 s request took the chunked path "
          f"({path.carry}, and {path.per_long_forward} {path.fwd})")
    rel = np.abs(out - whole).max() / np.abs(whole).max()
    log(f"long clip {path.name} 30 s, gates limit {limit >> 20} MiB: "
        f"{path.carry} launched {launched_c} times, rtf {inf.last_rtf:.5f}; "
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
    expected = {**dict.fromkeys(counts, 0), **path.per_step}
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch([(noisy, clean)]))   # ends in a fetch
        times.append((time.perf_counter() - t0) * 1e3)
        launched = {k: counts[k] - before[k] for k in counts}
        check(launched == expected,
              f"{path.name} train step {step + 1} launched {path.per_step} "
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


def phase_training_reference(dev, path):
    """A batch of 4 x 1 s: the bf16 loss and gradients on the card against
    the float32 model on the CPU."""
    import torch.nn.functional as F
    from generative_audio_torch.train import (
        enhance_loss_fn, init_enhance_state)
    noisy, clean = (torch.from_numpy(x) for x in
                    _noise_batch(SEED + 7, 4, 16000))
    grads, losses = {}, {}
    for name, device, dtype in (("card", dev, "bfloat16"),
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
    log(f"train reference {path.name}: 4 x 1 s, bf16 on the card vs float32 on "
        f"the CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f} (rel "
        f"{rel:.3e}); of {len(rows)} parameter tensors {len(carrying)} carry "
        f"the gradient (norm above 1e-3 of the largest): lowest cosine "
        f"{worst[0]:.4f} ({worst[3]}), norm ratios "
        f"{min(r[1] for r in carrying):.3f}-{max(r[1] for r in carrying):.3f}")
    for cos, ratio, share, k in rows:
        if ".sequence_model.weight_ih" in k or ".sequence_model.bias" in k \
                or ".sequence_model.weight_hh" in k:
            log(f"  {k}: cosine {cos:.5f}, norm ratio {ratio:.4f}, "
                f"norm/largest {share:.2e}")
    check(rel < TRAIN_LOSS_REL, f"bf16 loss vs float32 within {TRAIN_LOSS_REL}")
    check(worst[0] > TRAIN_GRAD_COS
          and all(abs(r[1] - 1) < TRAIN_GRAD_RATIO for r in carrying),
          f"bf16 gradients vs float32: cosine above {TRAIN_GRAD_COS}, norms "
          f"within {TRAIN_GRAD_RATIO}")


def _profile(fn, what):
    """torch.profiler's device time by kernel for one call of fn, against
    its wall time."""
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
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    check(busy > 0, f"torch.profiler recorded device time for {what}")
    log(f"profile: {what}, wall {wall:.2f} ms (profiled), "
        f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), on {card_line()}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


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
    for name, per_step in path.per_step.items():
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
        got = _count(counts, lambda: inf.enhance(noisy), {"lstm_scan_fwd": 2},
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
    per_run = {"lstm_scan_fwd": 2 * n_chunks}
    noisy = _noise(SEED + 30, 8, STREAM_SECONDS * cfg.sr)
    got = _count(counts, lambda: inf.enhance(noisy[0]), per_run,
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
    offline[8] = _count(counts, lambda: inf.overlapped_chunk(noisy), per_run,
                        "overlapped_chunk, 8 rows")
    for k in (1, 8):
        rows = noisy[0] if k == 1 else noisy
        for depth in (0, 2):
            stream = StreamingEnhancer(inf, n_streams=k, async_depth=depth)
            out = _count(counts,
                         lambda: _streamed(stream, rows, SEED + k + depth),
                         per_run, f"stream K={k} depth {depth}")
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
            _count(counts, lambda: inf.enhance_dir(
                clips, Path(tmp) / str(batch), log=lambda *_: None,
                batch_size=batch), {"lstm_scan_fwd": 8 if batch == 8 else 26},
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
                   {"lstm_scan_fwd": 6} if device != "cpu" else {},
                   f"the CLI on {device}")
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
    check(set(launched) == {"lstm_scan_fwd"},
          f"phase 13 launched kernel A and nothing else (got {launched})")
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
    per_val = {"lstm_scan_fwd": 2 * (len(VAL_SECONDS) - 1),
               "lstm_scan_fwd_carry": 2 * n_chunks}
    per_probe = {"lstm_scan_fwd": 2 * len(PROBE_SECONDS)}
    per_step = {"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2}

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
    return {k: v for k, v in launched.items()
            if k in ("lstm_scan_fwd", "lstm_scan_fwd_carry")}



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

    def make_timed(config, accum_steps=1, net=None):
        step = make_step(config, accum_steps, net)

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
        per_step = {"lstm_scan_fwd_train": 2, "lstm_scan_bwd": 2}
        per_val = {"lstm_scan_fwd_carry": 2 * n_chunks * CORPUS_VAL}
        per_probe = {"lstm_scan_fwd": 2 * CORPUS_PROBE}
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
        check(vlaunched == {"lstm_scan_fwd": 2 * CORPUS_VALIDATE_ITEMS},
              f"the validate CLI launched kernel A twice a clip "
              f"({vlaunched})")
        check(written == means and all(
            means[k] is not None and np.isfinite(means[k])
            for k in ("STOI", "SI_SDR")),
            f"validation_results.json with finite STOI and SI_SDR ({means})")
        launched = {k: v for k, v in L.launch_counts.items() if v}
        want = {"lstm_scan_fwd_train": 2 * len(steps),
                "lstm_scan_bwd": 2 * len(steps),
                "lstm_scan_fwd_carry": 3 * per_val["lstm_scan_fwd_carry"],
                "lstm_scan_fwd": 3 * per_probe["lstm_scan_fwd"]
                + 2 * CORPUS_VALIDATE_ITEMS}
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
            if k in ("lstm_scan_fwd", "lstm_scan_fwd_carry",
                     "lstm_scan_fwd_train", "lstm_scan_bwd")}


# Phase 16: the denoising-NPPC line at full width, bf16:
# scripts/denoising_nppc_e2e.py's configuration (the frozen enhancer
# FullSubNetPlusConfig(num_groups_in_drop_band=1), the head
# MultiDirectionConfig(n_directions=5, num_groups_in_drop_band=2), STFT
# 512/256/512) and configs/denoising_nppc.yaml's optimizer (lr 1e-4, lambda
# 0.1, grace 200).
NPPC_ENHANCER = {"num_groups_in_drop_band": 1}
NPPC_HEAD = {"n_directions": 5, "num_groups_in_drop_band": 2}
NPPC_BATCH, NPPC_SAMPLES, NPPC_STEPS = 8, 49152, 5
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
    check(launched == {"lstm_scan_fwd": 4},
          f"a 1 s forward launched 2 lstm_scan_fwd for the enhancer and 2 for "
          f"the head, nothing else (got {launched})")
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
    check(launched == {"lstm_scan_fwd": 2 * len(NPPC_HEAD_SEEDS)},
          f"each seed's head forward launched 2 lstm_scan_fwd, nothing else "
          f"(got {launched})")
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
        shift = L.card_scan_plan(dev, h, rows, train=True).rows % rows or 1
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
            f"{_plan_line(L, dev, h, rows, train=True)}): h max|err| "
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
            f"{_plan_line(L, dev, h, TRAIN_ROWS, train=True)})")
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
    per_step = {"lstm_scan_fwd": 2, "lstm_scan_fwd_train": 2,
                "lstm_scan_bwd": 2}
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
    log(f"train nppc: batch {NPPC_BATCH} x {NPPC_SAMPLES / 16000:.3f} s, "
        f"{cfg.pc_wrapper.n_directions} directions, bf16: objectives "
        f"{' '.join(f'{x:.6f}' for x in objectives)}, reconst_err "
        f"{' '.join(f'{x:.6f}' for x in reconst)}; the enhancer unchanged")
    log(f"train nppc: ms per step {' '.join(f'{x:.1f}' for x in times)}; "
        f"median of steps 2-{NPPC_STEPS} {steady:.2f} ms = "
        f"{NPPC_BATCH / steady * 1e3:.2f} clips/s; peak memory of steps "
        f"2-{NPPC_STEPS} {peak:.2f} GiB on {card_line()}")
    return trainer, (noisy, clean), total


def _nppc_reference(dev, cfg, params):
    """A 4 x 1 s batch: the objective, reconst_err and the head's gradients
    in bf16 on the card against the float32 trainer on the CPU, at the
    step where lambda reaches its scale (both terms of the objective)."""
    import torch.nn.functional as F
    noisy, clean = (torch.from_numpy(x) for x in
                    _noise_batch(SEED + 23, NPPC_REF_BATCH, NPPC_REF_SAMPLES))
    step = NPPC_CLI_TRAIN["second_moment_loss_grace"]
    out = {}
    for name, device, dtype in (("card", dev, torch.bfloat16),
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
        f"at step {step}, bf16 on the card vs float32 on the CPU: objective "
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
          f"bf16 objective and reconst_err vs float32 within {NPPC_OBJ_REL}")
    check(worst[0] > NPPC_GRAD_COS
          and all(abs(r - 1) < NPPC_GRAD_RATIO for r in ratios),
          f"bf16 head gradients vs float32: cosine above {NPPC_GRAD_COS}, "
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
    expected = {"lstm_scan_fwd_carry": 2 * 2 * n_chunks}
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
    per_step = {"lstm_scan_fwd": 2, "lstm_scan_fwd_train": 2,
                "lstm_scan_bwd": 2}
    n_dirs = [t.state.model.config.pc_wrapper.n_directions
              for t in (first, second)]
    log(f"nppc CLI: {NPPC_CLI_CLEAN} clean + {NPPC_CLI_NOISE} noise clips of "
        f"{NPPC_CLI_SECONDS} s, batch 8 x 3.0 s, {NPPC_CLI_WORKERS} workers: "
        f"{n_dirs} directions, objectives {first.loss_history} then "
        f"{second.loss_history}, restores {restores}, steps "
        f"{' '.join(f'{s * 1e3:.1f}' for s, _ in steps)} ms, final metrics "
        f"{final}")
    check(n_dirs == [5, 5], "the yaml's n_dirs built 5 directions")
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
                     {path.fwd: path.per_forward}, f"{path.name} 10 s request")
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
                  path.per_step, f"{path.name} training step")
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
    reject each result with its rows rolled by one."""
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
        faulty = within(out.roll(1, 1))
        log(f"{kernel} on {what}, call {i + 1} (T={out.shape[0]} "
            f"rows={out.shape[1]} H={out.shape[2]}): max|err| {max_e:.3e} "
            f"mean {mean_e:.3e}; rows rolled by 1: max {faulty[0]:.3e} mean "
            f"{faulty[1]:.3e}")
        check(torch.isfinite(out).all().item() and ok,
              f"{kernel} vs plain on {what}, call {i + 1} within "
              f"{KERNEL_MAX_ABS}/{mean_limit}")
        check(not faulty[2], f"the {kernel} limits reject rows rolled by 1 "
              f"({what}, call {i + 1})")


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
             {"lstm_scan_fwd_train": 4, "lstm_scan_bwd": 4}),
            ("GRU", "gru_scan_fwd",
             {"gru_scan_fwd": 4, "gru_scan_bwd": 4, "gru_scan_bwd_dwhh": 4})):
        model, ref = _complex_models(kind, dev, SEED + 60)
        b, t = COMPLEX_SERVE
        x = torch.from_numpy(_noise(SEED + 62, b, 2 * COMPLEX_FREQS, t) * 10)
        with torch.inference_mode(), _recorded_calls(
                R, scan=f"{kind.lower()}_scan_tm") as recorded:
            got = _count(counts, lambda: model(x.to(dev)), {fwd: 4},
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


def _ddp_launch(part, out, nprocs, backend, per_device=1):
    """cli.launch of this script's `--phase20 part out` in a session of its
    own (so that a launch past its time is killed whole); returns the
    Popen, its output going to out/part.log."""
    import os
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "generative_audio_torch.cli.launch",
           "--nprocs", str(nprocs), "--backend", backend]
    if per_device > 1:
        cmd += ["--ranks-per-device", str(per_device)]
    cmd += ["--", sys.executable, str(root / "chip_smoke.py"), "--phase20",
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
    check(proc.returncode == 0, f"phase 20 {part} launch exited 0 "
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
    the kernels line adds to the main path's."""
    check(torch.distributed.is_available()
          and torch.distributed.is_nccl_available(),
          "torch.distributed with NCCL on this machine")
    from generative_audio_torch.train import EnhanceTrainer
    t_phase = time.perf_counter()
    card = card_line()
    launched = {"lstm_scan_fwd_train": 0, "lstm_scan_bwd": 0}
    per_step = plus.per_step
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
                                      per_step.items()},
                  f"(a) cli.train run {i + 1}: {per_step} a step")
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
    for r in ranks:
        check(all(c == per_step for c in r["enhance"]["launches"]),
              f"(b) rank {r['rank']}: {per_step} a step (got "
              f"{r['enhance']['launches']})")
        for k in launched:
            launched[k] += sum(c.get(k, 0) for c in r["enhance"]["launches"])
    loss = ranks[0]["enhance"]["losses"][0]
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    a_vec = torch.cat([grads[k].flatten() for k in sorted(ref_grads)])
    b_vec = torch.cat([ref_grads[k].flatten() for k in sorted(ref_grads)])
    cos = float(a_vec @ b_vec / (a_vec.norm() * b_vec.norm()))
    norm_rel = float(abs(a_vec.norm() / b_vec.norm() - 1))
    log(f"phase 20 (b) gloo, 2 ranks x 9 rows on the card against one "
        f"process x 18: step-1 loss {loss:.6f} vs {ref_loss:.6f} (rel "
        f"{loss_rel:.2e}, limit {DDP_LOSS_REL:g}); averaged gradient cosine "
        f"{cos:.6f} (limit {DDP_GRAD_COS}), norm {a_vec.norm():.5f} vs "
        f"{b_vec.norm():.5f} (rel {norm_rel:.2e}, limit "
        f"{DDP_GRAD_NORM_REL}); ms a step (2 ranks sharing the card) "
        f"{ranks[0]['enhance']['ms']}; on {card}")
    check(sorted(grads) == sorted(ref_grads), "(b) the same gradients")
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
    return launched


def main():
    if sys.argv[1:2] == ["--phase20"]:
        return ddp_worker(*sys.argv[2:4])
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
    kernels = phase_kernels(dev, registers)
    kernels.update(phase_train_kernels(dev, registers))
    kernels["lstm_scan_bwd"]["full_band"] = phase_lstm_h512(dev, registers)
    phase_padded_hidden(dev)
    block_kernels, block_launches = phase_block_forwards(dev)
    kernels.update(block_kernels)
    phase_lstm_train_large(dev)
    kernels.update(phase_gru_kernels(dev))
    kernels.update(phase_gru_train_kernels(dev, registers))

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
                                 f"{pallas}:542")}
    plus, v1_gru, v1_lstm = model_paths()
    counts, plus_rtf = drive(dev, plus, ["lstm_scan_fwd", "lstm_scan_fwd_carry",
                                         "lstm_scan_fwd_train", "lstm_scan_bwd"])
    counts.update(drive(dev, v1_gru, [k for k in table if k.startswith("gru_")
                                      and not k.endswith("_block")])[0])
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
    for name, launched in phase_multi_gpu(dev, plus).items():
        counts[name] += launched
    counts.update(block_launches)
    phase_reference(dev, v1_lstm, v1_lstm.model(torch.bfloat16, dev))

    for phase in (lambda: phase_lstm_chains(
                      dev, kernels["lstm_scan_bwd"]["library_ms"], registers),
                  lambda: phase_lstm_unroll(dev, registers)):
        numbers, launches = phase()
        kernels.update(numbers)
        counts.update(launches)
    (kernels["lstm_layer_fwd"], counts["lstm_layer_fwd"],
     kernels["lstm_layer_fwd_block"]) = phase_lstm_layer(
        dev, plus, kernels["lstm_scan_fwd"]["ms"], registers)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[name], **kernels[name]}
        for name, (source, replaces) in table.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
