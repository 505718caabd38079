"""Published peaks of the chips the benchmark runs on (NVIDIA H100 SXM data
sheet, dense rates without sparsity, at the 700 W power limit)."""

H100 = {
    'bf16_flops': 989e12,
    'fp32_flops': 67e12,
    'hbm_bytes_per_s': 3.35e12,
}


def for_device(name):
    """The table of the card ``torch.cuda.get_device_name()`` names."""
    if 'H100' in name:
        return H100
    raise ValueError(f'no table of peaks for {name!r}')
