"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

Every roofline share divides by these numbers, and so does a share of a
peak (``mfu``): never by a rate the program measures itself.  A card that
is not in the table has no peaks: the metrics that need one return
nothing.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
(no sparsity), at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Optional

#: peak rates of one card; flops by the precision the work runs in
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "flops": {
        "float64": 34e12,       # FP64 outside the tensor cores
        "float32": 67e12,       # FP32 outside the tensor cores (TF32 off)
        "tf32": 495e12,
        "bfloat16": 989e12,
        "float16": 989e12,
    },
}

_BY_NAME = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(device_name: str) -> Optional[dict]:
    """The peak table of a card, or None for a card the table lacks."""
    return _BY_NAME.get(device_name)
