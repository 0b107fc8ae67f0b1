"""The port's telemetry: the metrics registry of the serving path."""

from cfk_tpu_torch.telemetry.metrics import Histogram, Metrics

__all__ = ["Histogram", "Metrics"]
