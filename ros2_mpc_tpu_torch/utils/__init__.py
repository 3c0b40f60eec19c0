from . import roofline, telemetry
from .telemetry import Telemetry

__all__ = ["roofline", "telemetry", "Telemetry"]
