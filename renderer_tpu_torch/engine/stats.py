"""Observability: device memory accounting.

Parity targets:
- VRAM atomics + startup logging (reference: renderer/src/lib.rs:75-93,
  examples/sandbox/src/main.rs:119-127 print_memory_usage,
  physical_device.rs:109-119 memory-budget query) → `memory_usage()` /
  `log_memory_usage()` over `torch.cuda.memory_stats`.
- The `Bytes` pretty-printer (lib.rs:103-128).
"""

from __future__ import annotations

import torch


def format_bytes(n: int) -> str:
    """Bytes pretty-printer (lib.rs:103-128 prints the largest binary unit)."""
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024.0 or unit == "TiB":
            return f"{value:.2f} {unit}" if unit != "B" else f"{int(value)} B"
        value /= 1024.0
    return f"{value:.2f} TiB"


def memory_usage(device) -> dict:
    """Device memory of the caching allocator on `device` (the renderer's
    device; the VK_EXT_memory_budget analog): bytes in use, the peak, and
    the card's total. A CPU device has no such accounting and reports 0s."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return {"in_use": 0, "peak": 0, "limit": 0}
    if dev.type != "cuda":
        raise ValueError(f"memory_usage: unsupported device {dev}")
    stats = torch.cuda.memory_stats(dev)
    return {
        "in_use": stats.get("allocated_bytes.all.current", 0),
        "peak": stats.get("allocated_bytes.all.peak", 0),
        "limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def log_memory_usage(tag: str, device) -> str:
    u = memory_usage(device)
    line = (
        f"[{tag}] device memory in use: {format_bytes(u['in_use'])}, "
        f"peak: {format_bytes(u['peak'])}, limit: {format_bytes(u['limit'])}"
    )
    print(line)
    return line
