"""Peaks of the cards the benchmark runs on, by `torch.cuda.get_device_name()`.

H100 SXM (NVIDIA's data sheet): device memory at 3.35 TB/s; integer work on
132 SMs of 64 INT32 lanes at 1,980 MHz, the SM clock that nvidia-smi gives
as the card's maximum (`clocks.max.sm`), at its 700 W limit."""
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 132 * 64 * 1.98e9},
}
