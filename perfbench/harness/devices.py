"""The device a run uses: the check that it is there, and its description
in the result line."""

from __future__ import annotations

from typing import Any, Optional


def require(torch: Any, chips: int) -> Optional[str]:
    """None when ``chips`` CUDA devices are there, else why not."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the port on an NVIDIA GPU only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} found"
    return None


def describe(torch: Any, device: Any, memory_peak_bytes: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(memory_peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(memory_peak_bytes)}


def reset_peak(torch: Any, device: Any) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak(torch: Any, device: Any) -> int:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def sync(torch: Any, device: Any) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
