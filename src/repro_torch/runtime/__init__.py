"""The fault-tolerant training runtime: counterpart of ``repro.runtime``.

``faults`` (the deterministic fault plan), ``watchdog`` (heartbeats ->
the quorum mask), ``health`` (the HEALTHY -> DEGRADED -> RESTART ladder),
``straggler`` (the quorum collectives on the lane group) and ``elastic``
(the survivor topology).  ``launch.train`` drives them.
"""
from .elastic import ElasticMesh, plan_elastic_mesh
from .faults import Fault, FaultPlan, corrupt_leaf_file, parse_fault_plan
from .health import DEGRADED, HEALTHY, RESTART, HealthEvent, HealthMonitor
from .straggler import quorum_mean, quorum_stage
from .watchdog import Watchdog
