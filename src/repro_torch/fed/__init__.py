"""The federated layer of the port: the round engine (``engine``), the
batched sweep engine (``scan_engine``), clients, server and the device
aggregator and fault families."""
from repro_torch.fed.scan_engine import (ScanConfig, ScanEngine, ScanHistory,
                                         oracle_h, precompute_masks)

__all__ = ["ScanConfig", "ScanEngine", "ScanHistory", "oracle_h",
           "precompute_masks"]
