"""Entry points of the two LSTM scan variants that the JAX package keeps as
scripts (scripts/perf_lstm_chains.py, scripts/perf_lstm_unroll.py). The
kernels' wrappers are ops.lstm's (`lstm_scan_bwd_tm(..., n_chains=N)`,
`lstm_scan_tm(..., block_t=K)`); each module here names them as the script
does, holds the plain version and the script's A/B on the card, which
chip_smoke.py runs too (`python -m generative_audio_torch.scripts.<name>`
runs it alone, without the rest of chip_smoke)."""
