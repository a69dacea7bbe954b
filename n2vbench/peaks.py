"""Published peaks of the cards the benchmark knows, by a part of the
name ``torch.cuda.get_device_name`` gives. NVIDIA H100 SXM data sheet,
dense rates at the 700 W limit: 3.35 TB/s of HBM3, 67 TFLOP/s float32
outside the tensor cores, 495 TFLOP/s TF32, 989 TFLOP/s bfloat16."""
from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12,
             "tf32_flops": 495e12, "bf16_flops": 989e12},
}


def of(device_name: str):
    """The peaks of the named card, or None for a card not listed."""
    for part, peaks in PEAKS.items():
        if part in device_name:
            return peaks
    return None
