# Fault tolerance: checkpoint supervision and straggler work queues, the
# elastic ensemble-run supervisor and its chaos fault-injection harness.
from . import chaos, elastic, fault

__all__ = ["chaos", "elastic", "fault"]
