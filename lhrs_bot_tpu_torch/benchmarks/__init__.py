"""Measurement entry points of the port, run on the card with
`python -m lhrs_bot_tpu_torch.benchmarks.<name>`: counterparts of the JAX
package's `benchmarks/` probes.

  hbm_peak_probe  device-memory read rate of a hand-written reader
                  (csrc/hbm_probe.cu) against `torch.amax`
  int8_probe      chained int8 / bf16 product rates (csrc/int8_probe.cu)
                  against `torch._int_mm` / `torch.matmul` chains
  int8dots_ab     the int8-cache decode attention with int8 dots against
                  bf16 dots, alone and in the W4A8 decode step

The decode and prefill cells of `bench.py` are `lhrs_bot_tpu_torch.bench`.
"""
