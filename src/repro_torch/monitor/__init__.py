"""The FedGenGMM activation monitor of a served transformer."""
from repro_torch.monitor.activation_monitor import (FedGMMMonitor,
                                                    MonitorConfig,
                                                    extract_features,
                                                    feature_projection)

__all__ = ["FedGMMMonitor", "MonitorConfig", "extract_features",
           "feature_projection"]
