"""Published peaks of the cards the benchmark knows: NVIDIA's data sheet
for the H100 SXM (dense tensor-core rates, no sparsity; HBM3 bandwidth),
at the full 700 W power limit."""
from __future__ import annotations

PEAKS = {
    "H100": {"int8_ops": 1979e12, "bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def of(device_name: str) -> dict | None:
    """The peaks of the card ``torch.cuda.get_device_name()`` names, or
    None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def least_seconds(ops: int, nbytes: int, peak_ops: float,
                  peak_bytes: float) -> float:
    """The least time for the work: the larger of its operations at the
    peak rate and its bytes at the memory bandwidth."""
    return max(ops / peak_ops, nbytes / peak_bytes)
