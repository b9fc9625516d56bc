"""Distribution for the port, counterpart of ``repro.parallel``: the
serving fleet's series->shard placement (``fleet``).  The logical-axis
sharding and parameter partitioning (``sharding``, ``partition``) come
with ROADMAP queue 1 item 5."""
from .fleet import FleetPlan, plan_fleet, shard_of  # noqa: F401
