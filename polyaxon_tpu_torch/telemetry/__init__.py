"""Throughput accounting for the trainer: analytic step FLOPs and MFU."""

from .stats import mfu, peak_bf16_flops, train_step_flops

__all__ = ["mfu", "peak_bf16_flops", "train_step_flops"]
