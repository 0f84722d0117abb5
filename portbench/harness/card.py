"""The card: its facts and the frozen ceilings the yardstick divides by.

The integer rate is SMs x the highest SM clock ``nvidia-smi`` reports x 64
32-bit integer or logic results per clock per SM (compute capability 9.0,
CUDA C++ Programming Guide, arithmetic instruction throughput).  The
memory rate is the H100 SXM data sheet's 3.35 TB/s.  The power limit is
read beside them: a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import subprocess
from typing import Dict

__all__ = ["HBM_BYTES_PER_S", "INT32_PER_CLOCK_PER_SM", "card_facts"]

HBM_BYTES_PER_S = 3.35e12
INT32_PER_CLOCK_PER_SM = 64


def card_facts() -> Dict:
    """Name, SMs, highest and current SM clock (MHz), power limit (W), and
    the integer and memory ceilings of card 0."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,clocks.max.sm,clocks.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, max_clock, clock, power = (v.strip() for v in out.split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {
        "name": name,
        "sms": sms,
        "max_sm_clock_mhz": float(max_clock),
        "sm_clock_mhz": float(clock),
        "power_limit_w": float(power),
        "int_ops_per_s": sms * float(max_clock) * 1e6 * INT32_PER_CLOCK_PER_SM,
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
    }
