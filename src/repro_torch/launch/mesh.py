"""Hardware constants of one card, for the roofline; the counterpart of
the constants of ``src/repro/launch/mesh.py``.

The published peaks of the NVIDIA H100 SXM5 (NVIDIA's data sheet, dense,
no sparsity, at its 700 W limit): bf16 on the tensor cores, HBM3, NVLink 4
per direction.  The card these numbers are used with, as ``nvidia-smi
--query-gpu=name,power.limit`` reports it on the runs that PERF.md
records: NVIDIA H100 80GB HBM3, 700.00 W.  A card set below 700 W runs
slower under load; read its limit beside every share of these peaks.
The production mesh and sharding rules of the reference come with the
port's ``sharding/``.
"""
PEAK_FLOPS = 989.4e12        # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s per direction
