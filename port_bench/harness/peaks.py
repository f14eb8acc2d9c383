"""Published peaks of the cards the benchmark knows (NVIDIA's H100 SXM data
sheet: dense rates without sparsity, at the 700 W limit). A card that is not
here gets no roofline or MFU reading."""

PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(kind: str):
    for key, peak in PEAKS.items():
        if key in kind:
            return peak
    return None
