from repro_torch.kernels.ssd.ops import ssd, ssd_oracle, ssd_scan
from repro_torch.kernels.ssd.ref import ssd_ref, ssd_scan_ref

__all__ = ["ssd", "ssd_oracle", "ssd_scan", "ssd_ref", "ssd_scan_ref"]
