# Fault tolerance: checkpoint supervision and straggler work queues, the
# elastic ensemble-run supervisor and its chaos fault-injection harness;
# gradient compression and bucketing (collectives).
from . import chaos, collectives, elastic, fault

__all__ = ["chaos", "collectives", "elastic", "fault"]
